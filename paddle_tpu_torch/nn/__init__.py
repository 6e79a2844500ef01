"""``paddle.nn`` of the port.  Counterpart of ``paddle_tpu/nn``: ``Layer``
(a ``torch.nn.Module``) and every layer of the reference's list, with
its constructors and initializers (``device``, ``dtype`` and
``generator`` keyword-only); ``ParamAttr``; ``functional``;
``initializer``; gradient clipping; ``utils``.  ``Sequential``,
``LayerList``, ``ParameterList`` and ``LayerDict`` are torch's
containers as ``Layer`` s, naming their children ``0``, ``1``, ... as
``paddle_tpu``'s do, so state dict keys such as
``layer1.0.downsample.0.weight`` and ``down_blocks.0.1.1.attn2.to_k.weight``
match."""
from . import functional  # noqa: F401
from . import initializer  # noqa: F401
from .clip import (  # noqa: F401
    ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue, clip_grad_norm_,
)
from .common import (  # noqa: F401
    CELU, ELU, GELU, Dropout, Dropout2D, Embedding, Flatten, Hardshrink,
    Hardsigmoid, Hardswish, Hardtanh, Identity, LayerDict, LayerList,
    LeakyReLU, Linear, LogSigmoid, LogSoftmax, Mish, ParameterList,
    PReLU, ReLU, ReLU6, SELU, Sequential, Sigmoid, Silu, Softmax, Softplus,
    Softshrink, Softsign, Swish, Tanh, Tanhshrink, ThresholdedReLU,
    Upsample,
)
from .conv import Conv1D, Conv2D, Conv2DTranspose  # noqa: F401
from .layers import Layer  # noqa: F401
from .loss import (  # noqa: F401
    BCELoss, BCEWithLogitsLoss, CrossEntropyLoss, CTCLoss,
    CosineEmbeddingLoss, GaussianNLLLoss, HingeEmbeddingLoss, KLDivLoss,
    L1Loss, MSELoss, MarginRankingLoss, MultiLabelSoftMarginLoss,
    NLLLoss, PoissonNLLLoss, SmoothL1Loss, SoftMarginLoss,
    TripletMarginLoss,
)
from .vision_layers import (  # noqa: F401
    ChannelShuffle, CosineSimilarity, Fold, GridSampler,
    PairwiseDistance, PixelShuffle, PixelUnshuffle, Unfold,
    UpsamplingBilinear2D, UpsamplingNearest2D,
)
from .norm import (  # noqa: F401
    BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
    InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
    LocalResponseNorm, RMSNorm, SyncBatchNorm, running_stats_frozen,
)
from .param_attr import ParamAttr  # noqa: F401
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D  # noqa: F401
from .transformer import (  # noqa: F401
    MultiHeadAttention, Transformer, TransformerDecoder,
    TransformerDecoderLayer, TransformerEncoder, TransformerEncoderLayer,
)
from .rnn import (  # noqa: F401
    RNN, BiRNN, GRU, GRUCell, LSTM, LSTMCell, RNNCellBase, SimpleRNN,
    SimpleRNNCell,
)
from .misc_layers import (  # noqa: F401
    GLU, AlphaDropout, Bilinear, Dropout3D, Pad1D, Pad2D, Pad3D, RReLU,
    Unflatten, ZeroPad2D,
)
from . import utils  # noqa: F401
from .layers_nd import (  # noqa: F401
    AdaptiveAvgPool1D, AdaptiveAvgPool3D, AdaptiveLogSoftmaxWithLoss,
    AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D, AvgPool1D,
    AvgPool3D, BeamSearchDecoder, Conv1DTranspose, Conv3D,
    Conv3DTranspose, FeatureAlphaDropout, FractionalMaxPool2D,
    FractionalMaxPool3D, HSigmoidLoss, LPPool1D, LPPool2D, MaxPool1D,
    MaxPool3D, MaxUnPool1D, MaxUnPool2D, MaxUnPool3D, Maxout,
    MultiMarginLoss, RNNTLoss, Softmax2D, SpectralNorm,
    TripletMarginWithDistanceLoss, ZeroPad1D, ZeroPad3D, dynamic_decode,
)


def layer_norm_types():
    """The norm layers (the reference's list, for AMP's keep-fp32 rule)."""
    from .norm import _BatchNormBase

    return (_BatchNormBase, LayerNorm, GroupNorm, RMSNorm)

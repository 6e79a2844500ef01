"""Models of the port: Llama (serving parameters and the training
module), BERT (the encoder and its QA, classification and MLM heads) and
the SD v1.5 diffusion UNet (``UNet2DConditionModel``), the AdamW train
step, and the numpy bridge from ``paddle_tpu`` (parameters and buffers,
optimizer and loss-scaler state).  The vision models are in ``vision.models``."""
from .bert import (  # noqa: F401
    BertConfig, BertForMaskedLM, BertForQuestionAnswering,
    BertForSequenceClassification, BertModel, init_bert_params,
)
from .convert import (  # noqa: F401
    from_numpy_state, grad_scaler_state_to_port,
    grad_scaler_state_to_reference, load_numpy_state, numpy_state,
    optimizer_state_to_port, optimizer_state_to_reference, serving_params,
)
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, init_llama_params, params_to,
    rope_tables,
)
from .training import CompiledTrainStep  # noqa: F401
from .unet import UNet2DConditionModel, timestep_embedding  # noqa: F401

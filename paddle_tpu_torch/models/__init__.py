from .convert import (  # noqa: F401
    from_numpy_state, load_numpy_state, serving_params,
)
from .llama import (  # noqa: F401
    LlamaConfig, LlamaForCausalLM, init_llama_params, params_to,
    rope_tables,
)
from .training import CompiledTrainStep  # noqa: F401

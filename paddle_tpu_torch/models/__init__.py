from .convert import from_numpy_state  # noqa: F401
from .llama import (  # noqa: F401
    LlamaConfig, init_llama_params, params_to, rope_tables,
)

from .convert import (  # noqa: F401
    cache_from_jax,
    from_jax_params,
    from_vitef_state_dict,
    hf_gpt2_to_vitef,
    hf_llama_to_vitef,
    hf_vit_to_vitef,
    to_jax_params,
)
from .gpt2 import (  # noqa: F401
    GPT2_SIZES,
    GPT2Config,
    build_gpt2,
    gpt2_model_name,
    gpt2_transformer_config,
)
from .llama import (  # noqa: F401
    LLAMA_SIZES,
    LlamaConfig,
    build_llama,
    llama_transformer_config,
)
from .moe import MOE_SIZES, MoeConfig, build_moe, moe_transformer_config  # noqa: F401
from .patchtst import (  # noqa: F401
    PATCHTST_SIZES,
    PatchTSTConfig,
    build_patchtst,
    patchtst_model_name,
    patchtst_transformer_config,
)
from .registry import Model, build_model  # noqa: F401
from .speculative import generate_speculative  # noqa: F401
from .transformer import Transformer, TransformerConfig  # noqa: F401
from .vit import VIT_SIZES, ViTConfig, build_vit, vit_transformer_config  # noqa: F401

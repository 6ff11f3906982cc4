from .convert import from_jax_params, from_vitef_state_dict  # noqa: F401
from .registry import Model, build_model  # noqa: F401
from .transformer import Transformer, TransformerConfig  # noqa: F401
from .vit import VIT_SIZES, ViTConfig, build_vit, vit_transformer_config  # noqa: F401

from .attention import (  # noqa: F401
    attention_reference,
    attention_route,
    flash_attention,
    flash_bwd,
    flash_bwd_reference,
    fused_mha_packed,
    multi_head_attention,
    packed_mha_bwd,
    packed_mha_bwd_reference,
    packed_mha_reference,
    packed_mha_supported,
)
from .common import canonical_impl, mm_f32, resolve_impl, use_true_fp32  # noqa: F401
# The grouped product ``gmm`` stays ``ops.gmm.gmm``: its name is the module's.
from .gmm import gmm_reference, tgmm, tgmm_reference  # noqa: F401
from .gmm_fused import (  # noqa: F401
    gmm_dual,
    gmm_dual_reference,
    gmm_dy_swiglu,
    gmm_dy_swiglu_reference,
    gmm_swiglu,
    gmm_swiglu_reference,
    tgmm_swiglu,
    tgmm_swiglu_reference,
)
from .layernorm import (  # noqa: F401
    layer_norm,
    layer_norm_bwd_dx,
    layer_norm_bwd_dx_reference,
    layer_norm_reference,
)
from .losses import (  # noqa: F401
    fused_next_token_ce,
    make_fused_head_loss,
    next_token_cross_entropy,
)

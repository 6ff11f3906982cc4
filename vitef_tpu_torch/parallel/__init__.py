from .mesh import (  # noqa: F401
    ComputingConfig,
    Mesh,
    MeshLayout,
    Placement,
    build_computing_manager,
    build_mesh,
    computing_config_from_env,
    gathered,
    param_shardings,
    shard_batch,
    shard_params,
)
from .moe import (  # noqa: F401
    MoEFeedForward,
    apply_moe_ffn,
    apply_moe_ffn_sparse,
    init_moe_ffn,
    resolve_moe_impl,
    router_aux,
    router_aux_from_route,
)
from .sequence import (  # noqa: F401
    apply_transformer_sp,
    build_sp_group,
    make_sp_train_step,
    ring_attention,
    shard_positions,
    zigzag_permutation,
)
from .train_step import (  # noqa: F401
    TrainState,
    auto_grad_acc,
    cross_entropy_loss,
    init_train_state,
    make_eval_step,
    make_train_step,
)

from .mesh import (  # noqa: F401
    ComputingConfig,
    Mesh,
    MeshLayout,
    Placement,
    build_computing_manager,
    build_ep_mesh,
    build_mesh,
    build_pipeline_mesh,
    computing_config_from_env,
    gathered,
    param_shardings,
    shard_batch,
    shard_params,
)
from .moe import (  # noqa: F401
    MoEFeedForward,
    apply_moe_ffn,
    apply_moe_ffn_ep,
    apply_moe_ffn_ep_sparse,
    apply_moe_ffn_sparse,
    apply_moe_ffn_tp,
    init_moe_ffn,
    make_moe_ep_train_step,
    moe_ep_state_shardings,
    moe_param_shardings,
    resolve_moe_impl,
    router_aux,
    router_aux_from_route,
    shard_experts,
)
from .pipeline import (  # noqa: F401
    make_pipeline_train_step,
    place_stages,
    stack_block_params,
    unstack_block_params,
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

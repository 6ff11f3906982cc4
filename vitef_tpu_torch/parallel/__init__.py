from .moe import (  # noqa: F401
    MoEFeedForward,
    apply_moe_ffn,
    apply_moe_ffn_sparse,
    init_moe_ffn,
    resolve_moe_impl,
    router_aux,
    router_aux_from_route,
)
from .train_step import (  # noqa: F401
    TrainState,
    auto_grad_acc,
    cross_entropy_loss,
    init_train_state,
    make_eval_step,
    make_train_step,
)

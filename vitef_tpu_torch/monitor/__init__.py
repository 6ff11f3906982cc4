"""The run monitor: run directory, metric logs, checkpoints, seeding,
profiling and preemption. Counterpart of ``vitef_tpu/monitor/``."""

from .checkpoint import (  # noqa: F401
    Checkpointer,
    CheckpointerConfig,
    load_checkpoint_params,
    load_optimizer_state,
    model_state,
    optimizer_state,
)
from .logger import Logger, LoggerConfig  # noqa: F401
from .orchestrator import (  # noqa: F401
    RUN_DIR,
    EvalOrchestratorConfig,
    OrchestratorConfig,
    build_eval_orchestrator,
    build_orchestrator,
)
from .preemption import PreemptionGuard  # noqa: F401
from .profiler import StepTimer, trace  # noqa: F401
from .utility import Utility, UtilityConfig  # noqa: F401

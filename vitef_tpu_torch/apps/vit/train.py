"""Finetune ViT on downstream datasets while freezing selected components.
Counterpart of ``apps/vit/train.py`` (``TrainingConfig`` :54-127, ``train``
:144-400, ``main`` :403-411).

    python -m vitef_tpu_torch.apps.vit.train config=apps/vit/configs/cifar10.yaml \\
        dataset_name=cifar100 lr=0.01 components=[mha,ffn_fc1]

It writes the JAX package's run dir under ``<SAVING_DIR>/runs/<log_dir>``:
``config.json``, ``metrics/raw_0.jsonl`` (every ``logging_period`` steps
``loss``, ``step``, ``lr``, ``grad_norm``, with ``log_block_grad_norms``
``grad_norm_block_<i>``, ``elapsed_steps`` and ``ts``; after every
evaluation ``eval_acc``, ``eval_loss``, ``step``, ``ts``),
``metrics/info_model.jsonl``, ``logs/device_0.log`` and one checkpoint
(:mod:`vitef_tpu_torch.monitor.checkpoint`): it is saved only on a new best
``eval_acc``, and the best one is what survives; on a preemption request
the latest step is saved and survives instead. A second run in the same
dir (``overwrite=False``) resumes from that checkpoint.

The step is eager (:func:`vitef_tpu_torch.parallel.make_train_step`): the
train augment K10, then K1 forward and K2 backward in every block of every
microbatch on CUDA; batch ``batch_size`` splits into equal microbatches of
at most ``auto_microbatch`` rows (512 -> 2 x 256). Metrics stay on the card
between logging periods. The run is on the card unless ``device=cpu``;
without one it raises. ``remat`` recomputes each block in the backward
(``torch.utils.checkpoint``).

The mesh (:164-300): one process per card. A launch of several processes
gives each ``VITEF_COORDINATOR_ADDRESS``, ``VITEF_NUM_PROCESSES``,
``VITEF_PROCESS_ID`` and ``VITEF_LOCAL_RANK``
(:func:`~vitef_tpu_torch.parallel.mesh.computing_config_from_env`), or
calls :func:`train` inside a process group it made; the ranks form the
``('dp', 'tp')`` mesh of ``dp``/``tp`` (``dp=-1``: world // tp; dp · tp must
be the world size). Each rank's train loader takes the disjoint stride of
its dp index (``batch_size`` rows a step per rank, as each JAX process
loads its own), the microbatch split is taken on those rows, and:

- tp = 1 without ``fsdp``: parameters replicated, the data-parallel step
  (``make_train_step(mesh=)``) averaging the gradients over 'dp';
- tp > 1 or ``fsdp``: :func:`~vitef_tpu_torch.parallel.shard_params`, and
  the step on the sharded module.

Every rank evaluates the whole validation set and saves the checkpoint (the
sharded layout when there are several processes); the master alone writes
``config.json`` and the metric records. Attention keeps its kernel route
under every mesh: per rank it is ordinary attention on the local rows and,
under tp, on the local heads (the JAX package falls back to XLA attention
under tp or fsdp, since a ``pallas_call`` has no SPMD rule).
"""

from __future__ import annotations

import logging
import time
from contextlib import ExitStack
from dataclasses import asdict, dataclass

import torch
import torch.distributed as dist

from ...data.images import build_train_val_loader, make_iterable
from ...eval import run_evaluation
from ...models import build_model
from ...monitor import Checkpointer, Logger, PreemptionGuard, Utility, build_orchestrator
from ...monitor.checkpoint import (load_model_state, load_optimizer_state, model_pieces,
                                   optimizer_pieces)
from ...optim import build_optimizer, build_scheduler, freeze_components
from ...parallel import (auto_grad_acc, build_computing_manager, computing_config_from_env,
                         init_train_state, make_train_step, shard_params)
from ...utils.cli import load_config_from_cli
from .utils import resolve_device

logger = logging.getLogger("vitef")


@dataclass
class TrainingConfig:
    """The JAX package's TrainingConfig, field for field, and ``device``."""

    # Model
    model_name: str = "base"
    patch_size: int = 16
    image_dim: tuple = (3, 224, 224)
    components: list[str] | None = None
    pretrained: bool = True
    in21k: bool = True

    # Data
    dataset_name: str = "cifar10"
    train_size: float = 0.8
    batch_size: int = 512
    val_batch_size: int = 512
    data_dir: str | None = None
    num_workers: int = 8

    # Training
    n_steps: int = 10_000
    grad_acc_steps: int = 1
    grad_clip: float | None = None
    # Largest microbatch (0: no split); above it the step accumulates exact
    # gradients over equal microbatches.
    auto_microbatch: int = 256

    # Evaluation
    eval_period: int = 1000

    # Optimizer
    optimizer: str = "sgd"
    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 0.0

    # Scheduler
    scheduler: str = "constant"
    warmup: int = 2000
    min_factor: float = 0

    # Execution
    dp: int = -1
    tp: int = 1
    fsdp: bool = False
    compute_dtype: str = "float32"
    attn_impl: str = "auto"
    norm_impl: str = "auto"
    remat: bool = False
    log_block_grad_norms: bool = False

    # Orchestrator
    log_dir: str = ""
    overwrite: bool = False
    logging_period: int = 10
    logging_level: str = "INFO"
    seed: int = 42
    utility_period: int = 1000

    # The port's device: the card unless "cpu" is asked for
    device: str = "cuda"

    def __post_init__(self):
        if (self.eval_period <= 0) or (self.eval_period > self.n_steps):
            self.eval_period = self.n_steps
        if self.seed is None:
            self.seed = 42
        if isinstance(self.image_dim, list):
            self.image_dim = tuple(self.image_dim)


def _rewind_scheduler(scheduler, step: int) -> None:
    """Put a ``LambdaLR`` at ``step``: the next update takes ``lr * schedule(step)``."""
    scheduler.last_epoch = step
    for group, base, schedule in zip(scheduler.optimizer.param_groups, scheduler.base_lrs,
                                     scheduler.lr_lambdas):
        group["lr"] = base * schedule(step)
    scheduler._last_lr = [group["lr"] for group in scheduler.optimizer.param_groups]


def train(config: TrainingConfig) -> None:
    """Run training, checkpointing the best evaluated model."""
    device = resolve_device(config.device)
    joined = not dist.is_initialized()
    mesh = build_computing_manager(computing_config_from_env(config.dp, config.tp, config.fsdp),
                                   device=device.type)
    joined = joined and dist.is_initialized()  # the group this run set up, and leaves
    # the data-parallel step wherever there are ranks and nothing is sharded
    dp_step = mesh.tp == 1 and not config.fsdp and dist.is_initialized()
    with ExitStack() as context_stack:
        if joined:
            context_stack.callback(dist.destroy_process_group)
        orchestrator = build_orchestrator({
            "log_dir": config.log_dir,
            "overwrite": config.overwrite,
            "config_file": asdict(config),
            "checkpoint_period": 0,
            "checkpoint_n_kept": 1,
            "logging_period": config.logging_period,
            "logging_level": config.logging_level,
            "seed": config.seed,
            "utility_period": config.utility_period,
        })
        metric_logger = Logger(config=orchestrator["logger"], eval=False)
        context_stack.enter_context(metric_logger)
        # seeds numpy's global RNG, which draws the train/val split
        utility = context_stack.enter_context(Utility(config=orchestrator["utility"]))

        logger.info("Building dataloaders.")
        loader_config = {
            "dataset_name": config.dataset_name,
            "batch_size": config.batch_size,
            "val_batch_size": config.val_batch_size,
            "size": config.image_dim[-1],
            "num_workers": config.num_workers,
            "compute_dtype": config.compute_dtype,
            "seed": config.seed,
            # data parallelism: each rank loads a disjoint shard of each epoch
            "shard_index": mesh.dp_rank,
            "shard_count": mesh.dp,
        }
        if config.data_dir:
            loader_config["save_dir"] = config.data_dir
        train_loader, val_loader, n_classes = build_train_val_loader(
            loader_config, device=device, train_size=config.train_size,
            return_n_classes=True)
        logger.info("Done building dataloaders.")

        logger.info("Building model.")
        model, model_config = build_model(
            {"implementation": "vit", "model_name": config.model_name,
             "pretrained": config.pretrained, "in21k": config.in21k,
             "patch_size": config.patch_size, "image_dim": config.image_dim,
             "finetuning": True, "n_classes": n_classes,
             "compute_dtype": config.compute_dtype, "attn_impl": config.attn_impl,
             "norm_impl": config.norm_impl, "remat": config.remat},
            device=device, generator=torch.Generator().manual_seed(config.seed),
            return_config=True)
        module = model.module
        trainable = freeze_components(module, config.components)
        if mesh.tp > 1 or config.fsdp:
            shard_params(model, mesh, fsdp=config.fsdp)
        layout = getattr(module, "mesh_layout", None)
        logger.info("Done building model.")

        logger.info("Building optimizer.")
        schedule = build_scheduler({"scheduler": config.scheduler, "warmup": config.warmup,
                                    "min_factor": config.min_factor}, n_steps=config.n_steps)
        optimizer, scheduler = build_optimizer(
            {"optimizer": config.optimizer, "lr": config.lr, "momentum": config.momentum,
             "weight_decay": config.weight_decay}, module, schedule=schedule)
        grad_acc_steps = config.grad_acc_steps
        if grad_acc_steps == 1 and config.auto_microbatch > 0:
            # each rank's loader gives it batch_size rows, on its one card
            grad_acc_steps = auto_grad_acc(config.batch_size, config.auto_microbatch)
            if grad_acc_steps > 1:
                logger.info(f"Per-device batch {config.batch_size} > auto_microbatch "
                            f"{config.auto_microbatch}: using exact gradient accumulation "
                            f"x{grad_acc_steps}.")
        step_fn = make_train_step(grad_acc_steps=grad_acc_steps, schedule=schedule,
                                  base_lr=config.lr, grad_clip=config.grad_clip,
                                  block_grad_norms=config.log_block_grad_norms,
                                  mesh=mesh if dp_step else None)
        state = init_train_state(model, optimizer, scheduler)
        logger.info("Done building optimizer.")

        def get_state():  # this rank's pieces; the checkpointer picks the layout
            return {"model": model_pieces(module), "optim": optimizer_pieces(optimizer, module),
                    "training": {"step": state.step, "acc_step": state.acc_step}}

        def set_state(model_flat, optim_flat, training):
            load_model_state(module, model_flat)
            if optim_flat is not None:
                load_optimizer_state(optimizer, module, optim_flat)
            state.step = int(training["step"])
            state.acc_step = int(training.get("acc_step", 0))
            _rewind_scheduler(scheduler, state.step)

        checkpoint = Checkpointer(config=orchestrator["checkpointer"], get_state=get_state,
                                  set_state=set_state, model_config=model_config)
        context_stack.enter_context(checkpoint)  # auto-resume

        metric_logger.report_model_size(
            module if layout is None else
            {name: torch.empty(shape, device="meta")
             for name, shape in layout.full_shapes.items()}, trainable)
        current_time = time.time()
        current_step = state.step
        checkpoint.sync_step(current_step)

        logging_period = orchestrator["logger"].period
        eval_period = config.eval_period
        best_eval_accuracy = 0.0
        best_eval_step = 0

        iterator = iter(make_iterable(train_loader))
        preempt = context_stack.enter_context(PreemptionGuard())
        preempted = False

        step = current_step
        while step < config.n_steps:
            if config.grad_acc_steps > 1:
                xs, ys = zip(*(next(iterator) for _ in range(config.grad_acc_steps)))
                batch = (torch.cat(xs), torch.cat(ys))
            else:
                batch = next(iterator)
            last_metrics = step_fn(state, batch)  # the loader gives this rank its rows
            step = state.step

            utility()
            checkpoint()

            if preempt.requested:
                logger.info(f"Preemption requested: saving checkpoint at step {step} and "
                            "exiting (resume will continue from here).")
                checkpoint.update()
                preempted = True
                break

            # the only host synchronisation between evaluations
            if (logging_period > 0) and (step % logging_period == 0):
                logger.info(f"Metric logging at step {step}.")
                elapsed_time = time.time() - current_time
                elapsed_steps = step - current_step
                current_time, current_step = time.time(), step
                metric_logger({
                    "loss": last_metrics["loss"].item(),
                    "step": step,
                    "lr": float(last_metrics["lr"]),
                    "grad_norm": last_metrics["grad_norm"].item(),
                    **{k: v.item() for k, v in last_metrics.items()
                       if k.startswith("grad_norm_block_")},
                    "elapsed_steps": elapsed_steps,
                    "ts": elapsed_time,
                })

            if (eval_period > 0) and (step % eval_period == 0):
                logger.info(f"Evaluation at step {step}.")
                metrics = run_evaluation(model, val_loader)
                metrics |= {"step": step}
                metric_logger(metrics)
                if metrics["eval_acc"] > best_eval_accuracy:
                    best_eval_accuracy = metrics["eval_acc"]
                    best_eval_step = step
                    logger.info(f"Saving the current best model (validation accuracy of "
                                f"{best_eval_accuracy * 100:.2f}%).")
                    checkpoint.update()

        # The checkpoint that survives is the best evaluated one; after a
        # preemption it is the latest.
        if not preempted:
            checkpoint.sync_step(best_eval_step)

    logger.info("Training preempted." if preempted else "Training done.")


def main(argv: list[str] | None = None) -> None:
    """``python -m vitef_tpu_torch.apps.vit.train config=<yaml> [k=v ...]``:
    defaults <- yaml <- dotted overrides (``sys.argv[1:]`` unless ``argv``)."""
    train(load_config_from_cli(TrainingConfig, argv))


if __name__ == "__main__":
    main()

"""Device mesh, sharding rules and multi-process setup. Counterpart of
``vitef_tpu/parallel/mesh.py`` (rank helpers :47-75, ``ComputingConfig``
:81-95, ``build_mesh`` :98-108, ``build_computing_manager`` :111-138, the
sharding rules :143-204, ``shard_batch`` :212-231).

One process per card, as NCCL wants it: the ``torch.distributed`` default
group holds every rank, and :class:`Mesh` lays its ranks out as a
``('dp', 'tp')`` grid, rank r at (r // tp, r % tp), the JAX package's
``devices.reshape(dp, tp)``. Each rank belongs to one dp group (the ranks
that share its tp index) and one tp group. The same grid with 'pp'
(:func:`build_pipeline_mesh`, ``parallel/pipeline.py``) or 'ep'
(:func:`build_ep_mesh`, the expert-parallel MoE of ``parallel/moe.py``) as
its fast axis places pipeline stages and expert owners.

- Data parallelism: every parameter is replicated; each rank computes on its
  own rows and the train step averages the gradients over 'dp'.
- Tensor parallelism (tp > 1, ``_TP_RULES``): each rank holds H/tp heads of
  the packed qkv and the attention output and F/tp columns of fc1 and fc2
  (:mod:`~vitef_tpu_torch.models.tensor_parallel`). The JAX package splits
  the packed qkv (E, 3E) along its columns contiguously; the port splits it
  by heads, so that a rank's slice is ``[q | k | v]`` of its own heads and
  the attention kernels run on it as they are (swiglu's packed
  ``[gate | up]`` fc1 likewise).
- FSDP: each parameter is further split over 'dp' along its largest
  divisible free axis (of the JAX layout, as ``_largest_divisible_axis``
  picks it). The rank keeps its shard, and its optimizer state is the
  shard's; the train step gathers the full parameters over 'dp' for the
  forward and the backward (for the whole step, so its peak memory for
  parameters and gradients is the unsharded model's) and reduce-scatters
  their gradients, so that each rank receives its shard's average.

:func:`shard_params` applies the placement to a model in place and records
it as the module's ``mesh_layout`` (:class:`MeshLayout`), which the train
step, the checkpoint and the server read. The rank helpers read
``VITEF_NUM_PROCESSES`` and ``VITEF_LOCAL_RANK``; a launch of several
processes gives each of them ``VITEF_COORDINATOR_ADDRESS``,
``VITEF_NUM_PROCESSES``, ``VITEF_PROCESS_ID`` and ``VITEF_LOCAL_RANK``
(:func:`computing_config_from_env`).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import socket
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


# ------------------------------------------------------------------------------
# Rank helpers
# ------------------------------------------------------------------------------


def is_distributed_job() -> bool:
    """Whether this process is one of a multi-process launch
    (``VITEF_NUM_PROCESSES`` > 1)."""
    return int(os.environ.get("VITEF_NUM_PROCESSES", "1")) > 1


def get_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_local_rank() -> int:
    """This process's card on its host (``VITEF_LOCAL_RANK``, default 0)."""
    return int(os.environ.get("VITEF_LOCAL_RANK", "0"))


def get_world_size() -> int:
    """The number of processes in the default group, 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_master_process() -> bool:
    return get_rank() == 0


@functools.cache
def get_hostname() -> str:
    return socket.gethostname()


# ------------------------------------------------------------------------------
# The mesh
# ------------------------------------------------------------------------------


@dataclass
class ComputingConfig:
    """``dp=-1`` means world_size // tp; ``fsdp`` shards the parameters over
    'dp'. ``coordinator_address`` (host:port of rank 0), ``num_processes``
    and ``process_id`` set up the process group of a multi-process run."""

    dp: int = -1
    tp: int = 1
    fsdp: bool = False
    coordinator_address: str | None = None
    num_processes: int = 1
    process_id: int = 0


class Mesh:
    """A grid over the ranks of the default process group: ``('dp', 'tp')``
    (:func:`build_mesh`), ``('dp', 'pp')`` (:func:`build_pipeline_mesh`) or
    ``('dp', 'ep')`` (:func:`build_ep_mesh`), made as ``Mesh(dp, tp=n)``,
    ``Mesh(dp, pp=n)`` or ``Mesh(dp, ep=n)`` (``tp=1`` when none is given).
    The second axis, ``inner`` (``n_inner`` ranks), varies fastest: rank r
    sits at (r // n_inner, r % n_inner). ``dp_group`` and ``inner_group``
    are this rank's groups along each axis; both are None without a process
    group (one process), and then no collective runs. ``tp``, ``pp`` and
    ``ep`` (and their groups and ranks) read the inner axis where it is
    theirs, and are 1 (None, 0) on a mesh without that axis."""

    def __init__(self, dp: int, rank: int = 0, dp_group: Any = None, inner_group: Any = None,
                 world_group: Any = None, **inner_size: int):
        if len(inner_size) > 1 or not set(inner_size) <= {"tp", "pp", "ep"}:
            raise ValueError(f"a mesh has one inner axis, tp, pp or ep; got {inner_size}")
        ((self.inner, self.n_inner),) = (inner_size or {"tp": 1}).items()
        self.dp, self.rank = dp, rank
        self.dp_group, self.inner_group, self.world_group = dp_group, inner_group, world_group

    def __repr__(self) -> str:
        return f"Mesh(dp={self.dp}, {self.inner}={self.n_inner}, rank={self.rank})"

    @property
    def axis_names(self) -> tuple[str, str]:
        return ("dp", self.inner)

    @property
    def shape(self) -> dict[str, int]:
        return {"dp": self.dp, self.inner: self.n_inner}

    @property
    def size(self) -> int:
        return self.dp * self.n_inner

    @property
    def dp_rank(self) -> int:
        return self.rank // self.n_inner

    def _size(self, axis: str) -> int:
        return self.n_inner if self.inner == axis else 1

    def _group(self, axis: str):
        return self.inner_group if self.inner == axis else None

    def _rank(self, axis: str) -> int:
        return self.rank % self.n_inner if self.inner == axis else 0

    tp = property(lambda self: self._size("tp"))
    pp = property(lambda self: self._size("pp"))
    ep = property(lambda self: self._size("ep"))
    tp_group = property(lambda self: self._group("tp"))
    pp_group = property(lambda self: self._group("pp"))
    ep_group = property(lambda self: self._group("ep"))
    tp_rank = property(lambda self: self._rank("tp"))
    pp_rank = property(lambda self: self._rank("pp"))
    ep_rank = property(lambda self: self._rank("ep"))

    def __deepcopy__(self, memo):  # process groups are shared, never copied
        return self


def _grid(dp: int, inner: str, n: int) -> Mesh:
    """The ``('dp', inner)`` mesh of ``dp * n`` ranks over the default
    group, rank d * n + i at (d, i); without a group, one rank and no
    groups. Every rank makes every group, in the same order."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(dp, **{inner: n})
    rank = dist.get_rank()
    dp_group = inner_group = None
    for i in range(n):
        group = dist.new_group([d * n + i for d in range(dp)])
        if rank % n == i:
            dp_group = group
    for d in range(dp):
        group = dist.new_group([d * n + i for i in range(n)])
        if rank // n == d:
            inner_group = group
    return Mesh(dp, rank=rank, dp_group=dp_group, inner_group=inner_group,
                world_group=dist.group.WORLD, **{inner: n})


def build_mesh(dp: int = -1, tp: int = 1) -> Mesh:
    """The ('dp', 'tp') mesh over the default group's ranks (one rank and no
    group when there is none). ``dp=-1`` means world // tp; ``dp * tp`` must
    equal the world size (AssertionError, as the JAX package asserts)."""
    world = get_world_size()
    if dp == -1:
        dp = world // tp
    if dp * tp != world:
        raise AssertionError(f"dp * tp = {dp}*{tp} must equal the number of devices ({world})")
    return _grid(dp, "tp", tp)


def build_pipeline_mesh(pp: int, dp: int = 1) -> Mesh:
    """The ('dp', 'pp') mesh of ``vitef_tpu/parallel/pipeline.py``
    (:102-112): pipeline stages vary fastest, rank d * pp + s is stage s of
    data-parallel row d. ``dp * pp`` must equal the world size
    (AssertionError)."""
    world = get_world_size()
    if dp * pp != world:
        raise AssertionError(f"dp * pp = {dp}*{pp} must equal the number of devices ({world})")
    return _grid(dp, "pp", pp)


def build_ep_mesh(ep: int, dp: int = 1) -> Mesh:
    """The ('dp', 'ep') mesh of the expert-parallel MoE
    (``vitef_tpu/parallel/moe.py`` :1026-1060; dp = 1 is its ``('ep',)``
    mesh): expert owners vary fastest, rank d * ep + j owns the j-th block
    of experts in data-parallel row d. ``dp * ep`` must equal the world
    size (AssertionError)."""
    world = get_world_size()
    if dp * ep != world:
        raise AssertionError(f"dp * ep = {dp}*{ep} must equal the number of devices ({world})")
    return _grid(dp, "ep", ep)


def computing_config_from_env(dp: int = -1, tp: int = 1, fsdp: bool = False) -> ComputingConfig:
    """A :class:`ComputingConfig` with the mesh knobs given and the process
    fields from the environment of a multi-process launch:
    ``VITEF_COORDINATOR_ADDRESS`` (host:port of rank 0),
    ``VITEF_NUM_PROCESSES`` and ``VITEF_PROCESS_ID`` (and
    ``VITEF_LOCAL_RANK``, the card, read by :func:`build_computing_manager`).
    Outside such a launch (:func:`is_distributed_job`) they keep their
    one-process defaults."""
    if not is_distributed_job():
        return ComputingConfig(dp=dp, tp=tp, fsdp=fsdp)
    return ComputingConfig(dp=dp, tp=tp, fsdp=fsdp,
                           coordinator_address=os.environ.get("VITEF_COORDINATOR_ADDRESS"),
                           num_processes=int(os.environ.get("VITEF_NUM_PROCESSES", "1")),
                           process_id=int(os.environ.get("VITEF_PROCESS_ID", "0")))


def build_computing_manager(config: dict | ComputingConfig | None = None, *,
                            device: str = "cuda") -> Mesh:
    """Set up the process group of a multi-process run, then build the mesh.

    With ``coordinator_address`` and ``num_processes`` > 1 every process
    joins the default group at ``tcp://<coordinator_address>`` as rank
    ``process_id``: over NCCL on its card ``cuda:VITEF_LOCAL_RANK`` (set as
    the current device), or over gloo when the caller asks for
    ``device="cpu"``."""
    from ..utils.typed import build_with_type_check

    if config is None:
        config = ComputingConfig()
    elif isinstance(config, dict):
        config = build_with_type_check(ComputingConfig, config)
    if config.coordinator_address and config.num_processes > 1 and not dist.is_initialized():
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(get_local_rank())
            backend = "nccl"
        else:
            backend = "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{config.coordinator_address}",
                                world_size=config.num_processes, rank=config.process_id)
        logger.info("Joined the %s group: rank %d/%d on %s", backend, config.process_id,
                    config.num_processes, get_hostname())
    mesh = build_mesh(config.dp, config.tp)
    logger.info("Device mesh: dp=%d tp=%d (%d ranks)", mesh.dp, mesh.tp, mesh.size)
    return mesh


# ------------------------------------------------------------------------------
# Sharding rules
# ------------------------------------------------------------------------------


def _largest_divisible_axis(shape: tuple, n: int) -> int | None:
    """The largest axis divisible by n (the first of equal ones), for FSDP."""
    best = None
    for i, s in enumerate(shape):
        if s % n == 0 and s >= n and (best is None or s > shape[best]):
            best = i
    return best


# Parameter-name suffix -> the axis split over 'tp', in the JAX layout
# (linear weights (in, out)): qkv and fc1 column-parallel, the attention
# output and fc2 row-parallel.
_TP_RULES = [
    ("attn.qkv_mat.weight", 1),
    ("attn.qkv_mat.bias", 0),
    ("attn.output.weight", 0),
    ("ffn.fc1.weight", 1),
    ("ffn.fc1.bias", 0),
    ("ffn.fc2.weight", 0),
]


@dataclass(frozen=True)
class Placement:
    """Where a parameter is split, in the port's layout: ``tp`` the axis
    split over 'tp', ``dp`` the axis split over 'dp' (FSDP), ``ep`` the axis
    split over 'ep' (an expert stack's expert axis), None when replicated
    along that mesh axis; ``pp`` a block parameter that lives on this
    rank's pipeline stage alone."""

    tp: int | None = None
    dp: int | None = None
    ep: int | None = None
    pp: bool = False


def _transposed(name: str, shape: tuple, names) -> bool:
    from ..models.convert import _transposed as linear_weight

    return linear_weight(name, len(shape), names)


def param_shardings(shapes: dict[str, tuple], mesh: Mesh | dict,
                    fsdp: bool = False) -> dict[str, Placement]:
    """``{name: Placement}`` for every parameter of ``shapes`` (name -> shape
    in the port's layout) on ``mesh`` (or a ``{'dp': .., 'tp': ..}``
    shape): the JAX package's rule (:166-199) taken on the JAX layout of
    each tensor, then mapped to the port's axes. With tp > 1 the
    ``_TP_RULES`` axis is split where it divides, and 3-D MoE expert stacks
    split their expert axis (:180-187). With ``fsdp`` and dp > 1 the largest
    divisible free axis is split over 'dp'."""
    shape = mesh.shape if isinstance(mesh, Mesh) else mesh
    dp, tp = shape["dp"], shape.get("tp", 1)
    out = {}
    for name, port_shape in shapes.items():
        port_shape = tuple(port_shape)
        flip = _transposed(name, port_shape, shapes)
        jshape = port_shape[::-1] if flip else port_shape
        spec: list = [None] * len(jshape)
        if tp > 1:
            if len(jshape) == 3 and ".ffn.fc" in name:
                if jshape[0] % tp == 0:
                    spec[0] = "tp"
            else:
                for pat, axis in _TP_RULES:
                    if name.endswith(pat) and jshape[axis] % tp == 0:
                        spec[axis] = "tp"
                        break
        if fsdp and dp > 1:
            free = tuple(s if spec[i] is None else 0 for i, s in enumerate(jshape))
            ax = _largest_divisible_axis(free, dp)
            if ax is not None:
                spec[ax] = "dp"

        def port_axis(kind):
            if kind not in spec:
                return None
            i = spec.index(kind)
            return len(spec) - 1 - i if flip else i

        out[name] = Placement(tp=port_axis("tp"), dp=port_axis("dp"))
    return out


@dataclass
class MeshLayout:
    """How a module's parameters lie on a mesh (``module.mesh_layout``).

    ``placements`` by parameter name; ``segments[name]`` lists, for a
    tensor split over 'tp', the runs ``(global start, local start, length)``
    along its tp axis that make up this rank's slice (three for the packed
    qkv, two for swiglu's fc1, one otherwise); ``full_shapes`` the shapes
    of the whole tensors in the port's layout. Under FSDP, ``units`` are the
    hooked units of :mod:`~vitef_tpu_torch.parallel.fsdp`, ``whole`` is set
    while :func:`gathered` holds every parameter whole, and ``held`` and
    ``peak_held`` count the elements held gathered (whole weights and whole
    gradients) now and at most."""

    mesh: Mesh
    placements: dict[str, Placement] = field(default_factory=dict)
    segments: dict[str, list[tuple[int, int, int]]] = field(default_factory=dict)
    full_shapes: dict[str, tuple] = field(default_factory=dict)
    units: list = field(default_factory=list)
    whole: bool = False
    held: int = 0
    peak_held: int = 0

    def placement(self, name: str) -> Placement:
        return self.placements.get(name, Placement())

    def fsdp_names(self) -> list[str]:
        return [n for n, p in self.placements.items() if p.dp is not None]

    # -- one tensor: whole <-> this rank's slice ---------------------------

    def _tp_slice(self, name: str, full: torch.Tensor) -> torch.Tensor:
        axis = self.placement(name).tp
        if axis is None:
            return full
        return torch.cat([full.narrow(axis, start, length)
                          for start, _, length in self.segments[name]], dim=axis)

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the whole tensor ``full`` (the port's layout)."""
        out = self._tp_slice(name, full)
        place = self.placement(name)
        if place.ep is not None:
            out = out.chunk(self.mesh.ep, dim=place.ep)[self.mesh.ep_rank]
        if place.dp is not None:
            out = out.chunk(self.mesh.dp, dim=place.dp)[self.mesh.dp_rank]
        return out.contiguous()

    def pieces(self, name: str, local: torch.Tensor) -> list[tuple[tuple, torch.Tensor]]:
        """``[(global starts, piece)]`` of this rank's slice ``local``, each a
        box of the whole tensor (the port's layout); empty where another rank
        writes the same values (a replica's first copy writes, as the JAX
        checkpoint's ``replica_id == 0``)."""
        place, mesh = self.placement(name), self.mesh
        if ((place.tp is None and mesh.tp_rank) or (place.dp is None and mesh.dp_rank)
                or (place.ep is None and mesh.ep_rank) or (not place.pp and mesh.pp_rank)):
            return []
        base = [0] * local.dim()
        if place.dp is not None:
            base[place.dp] = mesh.dp_rank * local.shape[place.dp]
        if place.ep is not None:
            base[place.ep] = mesh.ep_rank * local.shape[place.ep]
        if place.tp is None:
            return [(tuple(base), local)]
        out = []
        for start, lstart, length in self.segments[name]:
            starts = list(base)
            starts[place.tp] = start
            out.append((tuple(starts), local.narrow(place.tp, lstart, length)))
        return out

    def gather(self, name: str, shard: torch.Tensor) -> torch.Tensor:
        """The tp slice of ``name`` from its FSDP shards over 'dp'."""
        axis = self.placement(name).dp
        if axis is None or self.mesh.dp_group is None:
            return shard
        parts = [torch.empty_like(shard) for _ in range(self.mesh.dp)]
        dist.all_gather(parts, shard.contiguous(), group=self.mesh.dp_group)
        return torch.cat(parts, dim=axis)

    # -- the gradient's norm over the whole model -------------------------

    def global_norms(self, groups: list[list[tuple[str, torch.Tensor]]]) -> list[torch.Tensor]:
        """The L2 norm of each group of ``(name, tensor)`` pairs over the whole
        model: each rank's slices counted once, the replicas of a replicated
        tensor once. Per group, the squared norms of this rank's tensors are
        summed in four bins (split over tp or not, over dp or not), one
        all-reduce over every rank adds them up, and each bin is divided by
        its number of copies."""
        mesh = self.mesh
        device = next((t.device for g in groups for _, t in g), torch.device("cpu"))
        sums = torch.zeros(len(groups), 4, device=device)
        for i, group in enumerate(groups):
            for name, t in group:
                if t is None:
                    continue
                place = self.placement(name)
                b = 2 * (place.tp is not None) + (place.dp is not None)
                sums[i, b] += torch.linalg.vector_norm(t.float()).square()
        if mesh.world_group is not None:
            dist.all_reduce(sums, group=mesh.world_group)
        copies = torch.tensor([mesh.tp * mesh.dp, mesh.tp, mesh.dp, 1], dtype=torch.float32,
                              device=device)
        return list((sums / copies).sum(dim=1).sqrt())


def shard_params(model, mesh: Mesh, fsdp: bool = False):
    """Place ``model`` (a ``Model`` or its module) on ``mesh`` in place, per
    :func:`param_shardings`, and return it; ``module.mesh_layout`` records
    the placement.

    tp > 1: every block's qkv and attention output keep this rank's heads
    (their ``Linear.tp`` set), and its attention computes with
    :func:`~vitef_tpu_torch.models.tensor_parallel.local_config`; it needs
    n_heads and n_kv_heads divisible by tp (ValueError). A dense FFN's fc1
    and fc2 keep this rank's columns (ffn_dim divisible by tp). An MoE FFN
    keeps the rank's block of experts where tp divides n_experts (the JAX
    rule, :180-187) and computes the gate-masked oracle over them, one
    all-reduce over 'tp' at the combine
    (:func:`~vitef_tpu_torch.parallel.moe.apply_moe_ffn_tp`); otherwise its
    experts stay whole. ``fsdp``: each parameter keeps its shard over 'dp',
    and every forward gathers them unit by unit (the embedding, each block,
    the output; :func:`~vitef_tpu_torch.parallel.fsdp.install_units`), its
    backward too, reduce-scattering each unit's gradients as they complete;
    :func:`gathered` holds them all whole for code that reads the parameters
    outside a forward. An int8 weight (``Model.quantize_int8``) is split as
    its float weight is, and its per-column ``scale`` goes with the columns
    that a column split (qkv, fc1) or an expert split (MoE stacks) keeps;
    the row-parallel output and fc2 keep theirs whole."""
    from ..models.tensor_parallel import local_config

    module = getattr(model, "module", model)
    if getattr(module, "mesh_layout", None) is not None:
        raise ValueError("the module is already sharded")
    cfg = module.cfg
    names = {name: tuple(p.shape) for name, p in module.named_parameters()}
    layout = MeshLayout(mesh=mesh, placements=param_shardings(names, mesh, fsdp),
                        full_shapes=names)
    if mesh.tp > 1:
        local = local_config(cfg, mesh.tp)
        t, d = mesh.tp_rank, cfg.head_dim
        eq, kvd, f = local.n_heads * d, local.n_kv_heads * d, local.ffn_dim
        swiglu = cfg.ffn_type.lower() == "swiglu"
        e_loc = cfg.n_experts // mesh.tp
        runs = {
            "attn.qkv_mat": [(t * eq, 0, eq), (cfg.emb_dim + t * kvd, eq, kvd),
                             (cfg.emb_dim + cfg.kv_dim + t * kvd, eq + kvd, kvd)],
            "attn.output": [(t * eq, 0, eq)],
            "ffn.fc1": ([(t * f, 0, f), (cfg.ffn_dim + t * f, f, f)] if swiglu
                        else [(t * f, 0, f)]),
            "ffn.fc2": [(t * f, 0, f)],
        }
        modes = {"attn.qkv_mat": "column", "attn.output": "row", "ffn.fc1": "column",
                 "ffn.fc2": "row"}
        if cfg.n_experts:  # the expert axis, where it divides
            runs["ffn.fc1"] = runs["ffn.fc2"] = [(t * e_loc, 0, e_loc)]
            modes = {"attn.qkv_mat": "column", "attn.output": "row"}
        for i, block in enumerate(module.blocks):
            block.attn.cfg = local
            if cfg.n_experts:
                if cfg.n_experts % mesh.tp == 0:
                    block.ffn.tp = mesh
            else:
                block.ffn.cfg = local
            for path, mode in modes.items():
                block.get_submodule(path).tp = (mode, mesh)
            for path in runs:
                # an int8 weight's per-column scale goes with the columns (or
                # the experts) its weight keeps, not with a row split
                scale, weight = f"blocks.{i}.{path}.scale", f"blocks.{i}.{path}.weight"
                if scale in names and layout.placements[weight].tp == 0:
                    layout.placements[scale] = Placement(tp=0)
                for kind in ("weight", "bias", "scale"):
                    name = f"blocks.{i}.{path}.{kind}"
                    if name in names and layout.placements[name].tp is not None:
                        layout.segments[name] = runs[path]
    with torch.no_grad():
        for name, p in module.named_parameters():
            local_p = layout.local(name, p.data)
            if local_p.shape != p.shape:
                p.data = local_p.clone()
    module.mesh_layout = layout
    if layout.fsdp_names():
        from .fsdp import install_units

        layout.units = install_units(module, layout)
    return model


@contextlib.contextmanager
def gathered(model):
    """Hold ``model``'s FSDP-sharded parameters whole for the duration, for
    code that reads them outside a forward (the read-outs); their shards
    are put back after, and the per-unit gathers stand aside meanwhile. A
    forward alone needs none of it: it gathers unit by unit. A module
    without FSDP shards is left as it is."""
    module = getattr(model, "module", model)
    layout = getattr(module, "mesh_layout", None)
    names = layout.fsdp_names() if layout is not None else []
    params = dict(module.named_parameters())
    shards = {name: params[name].data for name in names}
    try:
        for name in names:
            params[name].data = layout.gather(name, shards[name])
        if layout is not None:
            layout.whole = True
        yield model
    finally:
        if layout is not None:
            layout.whole = False
        for name in names:
            params[name].data = shards[name]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of the global ``batch`` (a tuple or list of tensors
    with a leading batch axis): the ``dp_rank``-th of ``dp`` equal row
    blocks, so that the ranks of a tp group (or the stages of a pipeline)
    hold the same rows; on a ``('dp', 'ep')`` mesh, whose step splits the
    batch over every rank (``vitef_tpu/parallel/moe.py`` :1131), the
    ``rank``-th of ``dp · ep`` blocks. A loader given this rank's process
    shard (``shard_index``, ``shard_count``) already yields its rows, which
    go to the step as they are."""
    parts, index = (mesh.size, mesh.rank) if mesh.inner == "ep" else (mesh.dp, mesh.dp_rank)
    if parts == 1:
        return batch

    def rows(x):
        if x.shape[0] % parts:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over {parts} ranks")
        n = x.shape[0] // parts
        return x[index * n:(index + 1) * n]

    return type(batch)(rows(x) for x in batch)

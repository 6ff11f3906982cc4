"""Checkpoint manager: saves written in the background, in the JAX package's
on-disk layout. Counterpart of ``vitef_tpu/monitor/checkpoint.py``
(``CheckpointerConfig`` :50-60, the single-file layout :89-103 and
:185-201, ``Checkpointer`` :204-462).

- Step dirs ``{:010d}`` under ``<run>/checkpoints/``, each written into a
  temporary dir and renamed, so a dir appears whole: ``model.npz``,
  ``optim.npz``, ``training.json``, the model's ``params.json`` and an
  optional ``eval_<flag>`` marker that keeps the dir from the keep-last-
  ``n_kept`` clean-up.
- ``model.npz`` holds the parameters under the JAX package's dotted keys in
  its layout, linear weights (in, out) (:func:`model_state`, through
  :func:`~vitef_tpu_torch.models.convert.to_jax_params`), so either package
  loads the other's checkpoints.
- ``optim.npz`` holds torch's optimizer buffers (SGD's ``momentum_buffer``,
  AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step``) under
  ``<parameter name>.<buffer>``, with an entry naming the optimizer class
  (:func:`optimizer_state`). An ``optim.npz`` the JAX package wrote holds
  optax state, which the port does not read: loading it raises
  NotImplementedError rather than starting from a fresh optimizer.
- Staging: torch's optimizers update the parameters in place, so
  :meth:`Checkpointer.save` copies the whole state to the host, synchronously
  on the caller's thread, before it returns; only the file writes run on
  the worker thread, one save at a time. ``Checkpointer.timings`` records
  each save's staging and writing seconds.
- Entering the checkpointer resumes from the newest complete checkpoint;
  ``sync_step`` makes the exit-time save a no-op once the wanted checkpoint
  (the best evaluated one) is on disk.

- The sharded layout (:108-191, :217-225, :301-390), chosen whenever there
  is more than one process: each rank writes ``model.shard<rank>.npz`` and
  ``optim.shard<rank>.npz`` with its own pieces, each keyed
  ``<name>@<start,...>`` by its offsets in the whole tensor (a replicated
  tensor is written once, by the first rank that holds it); the master
  writes ``training.json``, ``params.json``, the eval flag and, last, as
  the marker that the dir is whole, ``index.json`` with ``n_processes``
  and each entry's shape and dtype. The model's pieces are in the JAX
  package's layout, so each package reads the other's sharded
  checkpoints; the optimizer's are the port's buffers. A reader rebuilds
  the whole arrays from the pieces (:func:`_assemble_from_shards`), and a
  module placed on a mesh (``parallel.mesh.shard_params``) then loads its
  own slices of them.
"""

from __future__ import annotations

import json
import logging
import re
import shutil
import tempfile
import time
from collections import defaultdict
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import _transposed, from_jax_params, to_jax_params
from ..parallel.mesh import get_rank, get_world_size, is_master_process
from ..utils.tree import json_serializable

logger = logging.getLogger("vitef")

# The entry of optim.npz that names the torch optimizer class of its buffers.
OPTIM_LAYOUT_KEY = "torch_optimizer"


@dataclass
class CheckpointerConfig:
    period: int = 0
    n_kept: int = 0
    path: str = ""

    def __post_init__(self):
        if self.period > 0 and not self.path:
            raise ValueError("Path was not set.")


# ------------------------------------------------------------------------------
# State <-> flat host arrays
# ------------------------------------------------------------------------------


def _host(value) -> np.ndarray:
    """``value`` on the host: a tensor is copied, synchronously, off its device;
    an array is taken as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True).numpy()
    return np.asarray(value)


@dataclass
class Pieces:
    """One process's part of a state entry: ``pieces`` keyed
    ``<name>@<start,...>`` (host arrays) and ``meta`` with every entry's
    whole ``shape`` and ``dtype``, as a sharded checkpoint holds them."""

    pieces: dict[str, np.ndarray]
    meta: dict[str, dict]


def _np_dtype(t: torch.Tensor) -> str:
    return str(torch.empty(0, dtype=t.dtype).numpy().dtype)


def _piece_key(name: str, starts) -> str:
    return f"{name}@{','.join(str(int(s)) for s in starts)}"


def model_state(module: nn.Module) -> dict[str, np.ndarray]:
    """The module's state as ``model.npz`` holds it: host copies under the
    JAX package's dotted keys, linear weights (in, out)."""
    return to_jax_params(module.state_dict())


def model_pieces(module: nn.Module) -> Pieces:
    """This rank's pieces of the module's state in the JAX package's layout
    (linear weights (in, out), the starts swapped with them), as
    ``model.shard<rank>.npz`` holds them. A module not placed on a mesh is
    one piece per tensor, written by the master."""
    layout = getattr(module, "mesh_layout", None)
    state = module.state_dict()
    pieces, meta = {}, {}
    for name, value in state.items():
        value = value.detach()
        flip = _transposed(name, value.dim(), state)
        shape = list(layout.full_shapes.get(name, value.shape)) if layout else list(value.shape)
        meta[name] = {"shape": shape[::-1] if flip else shape, "dtype": _np_dtype(value)}
        if layout is not None and name in layout.full_shapes:
            parts = layout.pieces(name, value)
        else:
            parts = [((0,) * value.dim(), value)] if is_master_process() else []
        for starts, piece in parts:
            if flip:
                starts, piece = starts[::-1], piece.t()
            pieces[_piece_key(name, starts)] = _host(piece.contiguous())
    return Pieces(pieces, meta)


def _local(module: nn.Module, name: str, full: torch.Tensor) -> torch.Tensor:
    """This rank's slice of the whole tensor ``full`` of parameter ``name``."""
    layout = getattr(module, "mesh_layout", None)
    if layout is None or name not in layout.full_shapes:
        return full
    return layout.local(name, full.reshape(layout.full_shapes[name]))


def load_model_state(module: nn.Module, flat: dict[str, np.ndarray]) -> None:
    """Load ``model.npz``'s entries (whole tensors) into ``module`` in place;
    a module placed on a mesh takes its own slices. Every entry of the module
    must be there (KeyError names the first missing one); extra entries are
    ignored, as the JAX package ignores them."""
    state = from_jax_params(flat)
    own = module.state_dict()
    for key in own:
        if key not in state:
            raise KeyError(f"checkpoint missing entry {key!r}")
    module.load_state_dict({key: _local(module, key, state[key]).reshape(value.shape)
                            for key, value in own.items()})


def optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module) -> dict[str, np.ndarray]:
    """The optimizer's buffers as ``optim.npz`` holds them: host copies under
    ``<parameter name>.<buffer>``, and the optimizer's class under
    ``OPTIM_LAYOUT_KEY``."""
    names = {p: name for name, p in module.named_parameters()}
    flat = {OPTIM_LAYOUT_KEY: np.array(type(optimizer).__name__)}
    for group in optimizer.param_groups:
        for p in group["params"]:
            for key, value in optimizer.state.get(p, {}).items():
                if value is not None:
                    flat[f"{names[p]}.{key}"] = _host(value)
    return flat


def optimizer_pieces(optimizer: torch.optim.Optimizer, module: nn.Module) -> Pieces:
    """This rank's pieces of :func:`optimizer_state` (the port's layout): a
    buffer of a parameter's shape lies where the parameter's slice lies, a
    0-d buffer is written by the rank that writes its parameter's first
    element (the master, off a mesh), the class entry by the master."""
    layout = getattr(module, "mesh_layout", None)
    names = {p: name for name, p in module.named_parameters()}
    pieces, meta = {}, {}
    layout_entry = np.array(type(optimizer).__name__)
    meta[OPTIM_LAYOUT_KEY] = {"shape": [], "dtype": str(layout_entry.dtype)}
    if is_master_process():
        pieces[_piece_key(OPTIM_LAYOUT_KEY, ())] = layout_entry
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[p]
            for key, value in optimizer.state.get(p, {}).items():
                if value is None:
                    continue
                entry = f"{name}.{key}"
                value = value.detach()
                whole = (layout.full_shapes[name] if layout is not None and value.dim()
                         else tuple(value.shape))
                meta[entry] = {"shape": list(whole), "dtype": _np_dtype(value)}
                if layout is not None and value.dim():
                    parts = layout.pieces(name, value)
                elif layout is not None:
                    first = any(not any(starts) for starts, _ in layout.pieces(name, p.data))
                    parts = [((), value)] if first else []
                else:
                    parts = [((0,) * value.dim(), value)] if is_master_process() else []
                for starts, piece in parts:
                    pieces[_piece_key(entry, starts)] = _host(piece.contiguous())
    return Pieces(pieces, meta)


def load_optimizer_state(optimizer: torch.optim.Optimizer, module: nn.Module,
                         flat: dict[str, np.ndarray]) -> None:
    """Load ``optim.npz``'s buffers (:func:`optimizer_state`'s layout) into
    ``optimizer``. Raises NotImplementedError for an ``optim.npz`` of the
    JAX package (optax state), ValueError for another optimizer class or a
    buffer of a parameter this optimizer does not update."""
    if OPTIM_LAYOUT_KEY not in flat:
        raise NotImplementedError(
            "optim.npz holds optax state (the JAX package's layout), which the port does "
            "not load; resume it with the JAX package, or start the port from model.npz "
            "alone by removing optim.npz")
    kind = str(flat[OPTIM_LAYOUT_KEY])
    if kind != type(optimizer).__name__:
        raise ValueError(f"optim.npz holds {kind} state, the optimizer is "
                         f"{type(optimizer).__name__}")
    params = dict(module.named_parameters())
    updated = {p for group in optimizer.param_groups for p in group["params"]}
    entries: dict[str, dict] = defaultdict(dict)
    for key, value in flat.items():
        if key != OPTIM_LAYOUT_KEY:
            name, _, buffer = key.rpartition(".")
            entries[name][buffer] = value
    for name, buffers in entries.items():
        p = params.get(name)
        if p is None or p not in updated:
            raise ValueError(f"optim.npz holds state of {name!r}, which this optimizer "
                             "does not update")
        # a 0-d step counter stays on the host, as torch keeps it; a module
        # placed on a mesh takes its slices of the whole buffers
        optimizer.state[p] = {
            buffer: torch.as_tensor(value) if buffer == "step"
            else _local(module, name, torch.as_tensor(value)).to(p.device)
            for buffer, value in buffers.items()}


def _write_state(path: Path, state: dict[str, Any]) -> None:
    """Write host state into ``path`` atomically (tmp dir + rename)."""
    tmp = Path(tempfile.mkdtemp(prefix=f".tmp_{path.name}_", dir=path.parent))
    try:
        np.savez(tmp / "model.npz", **state["model"])
        if state.get("optim") is not None:
            np.savez(tmp / "optim.npz", **state["optim"])
        with open(tmp / "training.json", "w") as f:
            json.dump(state.get("training", {}), f)
        if path.exists():  # re-save at the same step
            shutil.rmtree(path)
        tmp.rename(path)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _assemble(meta: dict[str, dict], shard_files) -> dict[str, np.ndarray]:
    """The whole arrays of ``meta`` from the pieces in ``shard_files`` (dicts
    or open npz files); raises when an entry is not covered."""
    out = {key: np.empty(m["shape"], dtype=np.dtype(m["dtype"])) for key, m in meta.items()}
    filled = dict.fromkeys(meta, 0)
    for z in shard_files:
        for piece_key in (z.files if hasattr(z, "files") else z):
            key, _, starts_s = piece_key.rpartition("@")
            piece = np.asarray(z[piece_key])
            starts = [int(s) for s in starts_s.split(",")] if starts_s else []
            out[key][tuple(slice(st, st + sz) for st, sz in zip(starts, piece.shape))] = piece
            filled[key] += piece.size
    for key, m in meta.items():
        if filled[key] < int(np.prod(m["shape"], dtype=np.int64)):
            raise ValueError(f"checkpoint entry {key!r} has missing shards")
    return out


def _whole(entry) -> dict[str, np.ndarray]:
    """A state entry as whole host arrays: :class:`Pieces` put together, or
    each tensor or array of a flat dict copied to the host."""
    if isinstance(entry, Pieces):
        return _assemble(entry.meta, [entry.pieces])
    return {k: _host(v) for k, v in entry.items()}


def _assemble_from_shards(path: Path, prefix: str) -> dict[str, np.ndarray]:
    """The whole arrays of ``<prefix>.shard<rank>.npz`` by ``index.json``."""
    with open(path / "index.json") as f:
        index = json.load(f)
    paths = [path / f"{prefix}.shard{rank}.npz" for rank in range(int(index["n_processes"]))]
    for shard_file in paths:
        if not shard_file.exists():
            raise FileNotFoundError(f"incomplete checkpoint: missing {shard_file.name}")
    files = []
    try:
        for shard_file in paths:
            files.append(np.load(shard_file))
        return _assemble(index[prefix], files)
    finally:
        for z in files:
            z.close()


def _load_flat(path: Path, prefix: str) -> dict[str, np.ndarray] | None:
    """A state entry as whole arrays, from ``<prefix>.npz`` or its shards;
    None when absent."""
    if (path / f"{prefix}.npz").exists():
        with np.load(path / f"{prefix}.npz") as z:
            return {k: z[k] for k in z.files}
    if (path / f"{prefix}.shard0.npz").exists():
        return _assemble_from_shards(path, prefix)
    return None


def load_checkpoint_params(path, module: nn.Module) -> nn.Module:
    """Load only the ``model`` entry of the checkpoint dir ``path`` into
    ``module`` (what eval and linear probing read) and return it."""
    flat = _load_flat(Path(path), "model")
    if flat is None:
        raise FileNotFoundError(f"no model entry in checkpoint {path}")
    load_model_state(module, flat)
    return module


class Checkpointer:
    """The JAX package's checkpoint lifecycle over host-staged state.

    ``get_state() -> {"model": flat, "optim": flat | None, "training": dict}``
    gives the state to save: this rank's :class:`Pieces`
    (:func:`model_pieces`, :func:`optimizer_pieces`), or, in a run of one
    process, whole tensors or arrays. The layout follows the number of
    processes: one writes ``model.npz`` and ``optim.npz`` (pieces are put
    together first), more save collectively in the sharded layout, which
    needs pieces.
    ``set_state(model_flat, optim_flat, training)`` applies a loaded
    checkpoint, as whole arrays.
    """

    folder_name = "{:010d}"
    re_folder = r"\d{10}"
    re_digits = re.compile(r"\d+")

    def __init__(self, config: CheckpointerConfig, get_state, set_state=None,
                 model_config: dict | None = None):
        self.period = config.period
        self.n_kept = config.n_kept
        self.path = Path(config.path)
        self.path.mkdir(parents=True, exist_ok=True)

        self.get_state = get_state
        self.set_state = set_state
        self.model_config = model_config

        self.device_rank = get_rank()
        self.saved_step = 0
        self.step = 0
        self.process: Future | None = None
        self._executor = ThreadPoolExecutor(max_workers=1)
        self.timings: list[dict] = []

    def sync_step(self, step: int) -> None:
        """Set both the current and the saved step to ``step``."""
        self.saved_step = self.step = step

    def __enter__(self) -> "Checkpointer":
        path = self.get_last_checkpoint_path(self.path)
        if path:
            self.load(path)
        return self

    def __exit__(self, exc, value, tb):
        try:
            if self.saved_step != self.step:
                self.update()
            if self.process is not None:
                logger.info("Waiting for final checkpoint to complete.")
                self.process.result()
        finally:
            self._executor.shutdown(wait=True)

    def __call__(self) -> None:
        """A train step's tick: saves every ``period`` steps."""
        self.step += 1
        if self.period > 0 and self.step % self.period == 0:
            self.update()

    def update(self, eval_flag: str = "") -> None:
        """Save at the current step; at a step already saved, only add the flag."""
        path = self.path / self.folder_name.format(self.step)
        if self.saved_step == self.step:
            if eval_flag:
                self._wait()
                if path.exists():
                    (path / f"eval_{eval_flag}").touch()
            return
        self.save(path, eval_flag)
        self._cleaning()
        self.saved_step = self.step

    def load(self, path) -> None:
        logger.info(f"Loading checkpoint from {str(path)}.")
        path = Path(path)
        model_flat = _load_flat(path, "model")
        if model_flat is None:
            raise FileNotFoundError(f"no model entry in checkpoint {path}")
        optim_flat = _load_flat(path, "optim")
        with open(path / "training.json") as f:
            training = json.load(f)
        if self.set_state is None:
            raise RuntimeError("Checkpointer has no set_state; cannot resume.")
        self.set_state(model_flat, optim_flat, training)
        self.sync_step(int(training.get("step", 0)))

    def save(self, path, eval_flag: str = "") -> None:
        """Join the previous save, copy the state to the host on this thread,
        and write it on the worker thread."""
        self._wait()
        if get_world_size() > 1:
            self._save_sharded(path, eval_flag)
            return
        if not is_master_process():
            return
        logger.info(f"Saving checkpoint at step {self.step} to {str(path)}.")
        t0 = time.perf_counter()
        state = self.get_state()
        staged = {
            "model": _whole(state["model"]),
            "optim": _whole(state["optim"]) if state.get("optim") is not None else None,
            "training": dict(state.get("training", {})),
        }
        timing = {"step": self.step, "stage_s": time.perf_counter() - t0}
        self.timings.append(timing)
        model_config = self.model_config

        def write():
            t1 = time.perf_counter()
            _write_state(Path(path), staged)
            if eval_flag:
                (Path(path) / f"eval_{eval_flag}").touch()
            if model_config is not None:
                with open(Path(path) / "params.json", "w") as f:
                    json.dump(json_serializable(model_config), f)
            timing["write_s"] = time.perf_counter() - t1

        self.process = self._executor.submit(write)

    def _save_sharded(self, path, eval_flag: str = "") -> None:
        """Every rank stages its pieces on this thread and writes its shard
        files on the worker; the master adds the json files and, last,
        ``index.json``."""
        logger.info(f"Saving sharded checkpoint at step {self.step} to {str(path)} "
                    f"(rank {self.device_rank}).")
        t0 = time.perf_counter()
        state = self.get_state()
        model, optim = state["model"], state.get("optim")
        # the index names every rank's entries (a pipeline stage holds only
        # its own blocks)
        every = [None] * get_world_size()
        dist.all_gather_object(every, (model.meta, None if optim is None else optim.meta))
        model = Pieces(model.pieces, {k: v for m, _ in every for k, v in m.items()})
        if optim is not None:
            optim = Pieces(optim.pieces, {k: v for _, m in every for k, v in m.items()})
        training = dict(state.get("training", {}))
        timing = {"step": self.step, "stage_s": time.perf_counter() - t0}
        self.timings.append(timing)
        model_config = self.model_config
        rank, master, n_proc = self.device_rank, is_master_process(), get_world_size()
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)

        def write():
            t1 = time.perf_counter()

            def write_json(name: str, obj) -> None:
                tmp = path / f".tmp.{name}"
                with open(tmp, "w") as f:
                    json.dump(obj, f)
                tmp.replace(path / name)

            for prefix, entry in (("model", model), ("optim", optim)):
                if entry is not None:
                    tmp = path / f".tmp.{prefix}.shard{rank}.npz"
                    np.savez(tmp, **entry.pieces)
                    tmp.replace(path / f"{prefix}.shard{rank}.npz")
            if master:
                write_json("training.json", training)
                if model_config is not None:
                    write_json("params.json", json_serializable(model_config))
                if eval_flag:
                    (path / f"eval_{eval_flag}").touch()
                index: dict[str, Any] = {"n_processes": n_proc, "model": model.meta}
                if optim is not None:
                    index["optim"] = optim.meta
                write_json("index.json", index)
            timing["write_s"] = time.perf_counter() - t1

        self.process = self._executor.submit(write)

    @classmethod
    def is_complete(cls, path) -> bool:
        """A dir is complete when its ``model.npz`` and ``training.json`` are
        there, or (a sharded one) its ``index.json``, ``training.json`` and
        every shard."""
        path = Path(path)
        if (path / "model.npz").exists():
            return (path / "training.json").exists()
        index_file = path / "index.json"
        if not index_file.exists() or not (path / "training.json").exists():
            return False
        try:
            with open(index_file) as f:
                n = int(json.load(f)["n_processes"])
        except (ValueError, KeyError, json.JSONDecodeError):
            return False
        return all((path / f"model.shard{r}.npz").exists() for r in range(n))

    @classmethod
    def get_last_checkpoint_path(cls, path) -> str:
        """The newest complete checkpoint dir, "" when there is none: a dir
        still being written, or left by a crash, never shadows it."""
        folders = [p for p in cls._list_checkpoints(Path(path)) if cls.is_complete(p)]
        if folders:
            return str(max(folders, key=lambda p: cls._get_key_step(p.name)))
        return ""

    def _wait(self) -> None:
        if self.process is not None:
            self.process.result()
            self.process = None

    def _cleaning(self) -> None:
        """Keep the newest ``n_kept`` complete checkpoints, and any with an
        ``eval_*`` marker; incomplete dirs older than the newest complete
        one are removed too."""
        if self.n_kept <= 0 or not is_master_process():
            return
        self._wait()
        all_checkpoints = sorted(self._list_checkpoints(self.path),
                                 key=lambda p: self._get_key_step(p.name))
        complete = [p for p in all_checkpoints if self.is_complete(p)]
        removable = set(complete[: -self.n_kept])
        if complete:
            newest_complete = self._get_key_step(complete[-1].name)
            removable |= {p for p in all_checkpoints
                          if not self.is_complete(p)
                          and self._get_key_step(p.name) < newest_complete}
        for prefix in sorted(removable, key=lambda p: self._get_key_step(p.name)):
            if not any(prefix.glob("eval_*")):
                logger.info(f"Removing: {str(prefix)}")
                shutil.rmtree(prefix)

    @classmethod
    def _list_checkpoints(cls, path: Path) -> list[Path]:
        return [p for p in path.iterdir() if p.is_dir() and re.match(cls.re_folder, p.name)]

    @classmethod
    def _get_key_step(cls, name: str) -> int:
        return int(re.findall(cls.re_digits, name)[-1])

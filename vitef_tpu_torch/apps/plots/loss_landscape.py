"""Loss-landscape and functional rate-of-change surfaces of one ViT component.
Counterpart of ``apps/plots/loss_landscape.py``.

    python -m vitef_tpu_torch.apps.plots.loss_landscape save [--device cpu]
    python -m vitef_tpu_torch.apps.plots.loss_landscape plot|results|frames|latex|gif

``save`` computes, for ln1, fc1 and mha at block 0 of ViT-B/16, on the card:

1. a short SGD trajectory of the component's parameters alone, taken as one
   flat vector (:func:`sgd_trajectory`), and the plane of its first two
   principal components (:func:`pca_plane`: sklearn's ``PCA(n_components=2)``
   computed exactly, the largest entry of each component positive);
2. the cross entropy of the batch on a grid of that plane (``Z_loss``) and
   the component's rate of change ‖f(x+δ)−f(x)‖/‖δ‖ on a grid of a plane of
   its input space (``Z_func``), spanned by the gradient of ‖f(x)‖ and a
   random sign vector made orthogonal to it (:func:`feature_plane`), one
   grid point after another on the device (:func:`surface_grid`);
3. the trajectory's coordinates on the PCA plane.

It pickles them to ``<SAVING_DIR>/loss_landscape/<comp>_block_<b>/*.pkl``,
which the other commands render (matplotlib, and imageio for ``gif``,
imported inside them) on any machine.

Differences from the JAX package, none of them in what is computed:

- The flat parameter vector follows the port's parameter order and (out, in)
  layout, a permutation of the JAX one. The surfaces, the trajectory's
  coordinates and the sign rule do not depend on it.
- The PCA is exact (an SVD of the centred trajectory in float64).
  The JAX package's sklearn call takes the randomized solver once the
  component has more than 500 parameters.
- The sign vector of the feature plane comes from a ``torch.Generator``
  seeded with ``seed``; the JAX package draws it from ``jax.random``.
  :func:`get_rates_of_change` takes it as ``signs=``.
- The trajectory's coordinates are those of the steps that the PCA was
  taken from; the JAX package takes the same steps a second time.

For fc2, whose input is ``ffn_dim`` wide, the feature point is zero-padded
to it, as in the plasticity decomposition. Entry points run on the card
unless ``device="cpu"``; without one they raise.
"""

from __future__ import annotations

import dataclasses
import logging
import pickle
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from ...config import FIGURE_DIR, SAVING_DIR, set_seed
from ...data.images import build_loader
from ...models import build_model
from ...utils.cli import make_cli
from ..vit.utils import resolve_device

logger = logging.getLogger("vitef")

SAVE_DIR = SAVING_DIR / "loss_landscape"

# component name -> its module inside a block
COMPONENT_MODULES = {
    "ln1": "attn_norm",
    "mha": "attn",
    "ln2": "ffn_norm",
    "fc1": "ffn.fc1",
    "fc2": "ffn.fc2",
}


class Component:
    """One component of one block of a ViT, its parameters taken as one flat
    vector: the model's loss and the component's own output as functions of
    that vector (``torch.func.functional_call``)."""

    def __init__(self, model, block: int, comp: str):
        self.model, self.comp = model, comp
        prefix = f"blocks.{block}.{COMPONENT_MODULES[comp]}"
        self.module = model.module.get_submodule(prefix)
        named = list(self.module.named_parameters())
        self.names = [name for name, _ in named]
        self.full_names = [f"{prefix}.{name}" for name in self.names]
        self.shapes = [p.shape for _, p in named]
        self.sub0 = torch.cat([p.detach().reshape(-1) for _, p in named])

    def unflatten(self, flat: torch.Tensor, full: bool = False) -> dict:
        names = self.full_names if full else self.names
        views, offset = {}, 0
        for name, shape in zip(names, self.shapes):
            n = shape.numel()
            views[name] = flat[offset:offset + n].view(shape)
            offset += n
        return views

    def loss(self, flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """The batch's mean float32 cross entropy with the component's
        parameters set to ``flat``."""
        logits = functional_call(self.model.module, self.unflatten(flat, full=True), (x,))
        return F.cross_entropy(logits.float(), y)

    def forward(self, feat: torch.Tensor, flat: torch.Tensor | None = None) -> torch.Tensor:
        """The component alone on ``feat`` (N, L, E), with its parameters set to
        ``flat`` (default: its own); fc2 reads ``feat`` zero-padded to its
        input width."""
        params = self.unflatten(self.sub0 if flat is None else flat)
        if self.comp in ("fc1", "fc2"):
            cd = self.model.config.cdtype()
            width = self.module.weight.shape[1]
            if feat.shape[-1] != width:
                feat = torch.cat([feat, feat.new_zeros(*feat.shape[:-1],
                                                       width - feat.shape[-1])], dim=-1)
            return functional_call(self.module, params, (feat, cd))
        return functional_call(self.module, params, (feat,))


@dataclass
class Plane:
    """What a surface is evaluated from: the batch, the component's flat
    parameters and the two PCA directions in parameter space, and one input
    of the component with the two directions of the feature plane."""

    x: torch.Tensor
    y: torch.Tensor
    sub0: torch.Tensor
    p_dx: torch.Tensor
    p_dy: torch.Tensor
    feat_input: torch.Tensor
    f_dx: torch.Tensor
    f_dy: torch.Tensor

    def to(self, device) -> "Plane":
        return Plane(**{f.name: getattr(self, f.name).to(device)
                        for f in dataclasses.fields(self)})


@dataclass
class Landscape:
    """Everything :func:`compute_landscape` made: the surfaces as the JAX
    package returns them, and the plane and trajectory they came from."""

    Z_loss: np.ndarray
    Z_func: np.ndarray
    u_coords: np.ndarray
    v_coords: np.ndarray
    trajectory: list
    component: Component
    plane: Plane
    params: torch.Tensor  # (n_steps, P): the flat parameters after each step
    losses: torch.Tensor  # (n_steps,): the loss before each step


def sgd_trajectory(component: Component, x, y, n_steps: int,
                   lr: float) -> tuple[torch.Tensor, torch.Tensor]:
    """``n_steps`` plain SGD steps of the component's parameters alone from
    its own: the (n_steps, P) parameters after each step and the loss before
    it, both on the device."""
    flat = component.sub0
    params = torch.empty((n_steps, flat.numel()), device=flat.device)
    losses = torch.empty(n_steps, device=flat.device)
    for step in range(n_steps):
        leaf = flat.detach().requires_grad_()
        loss = component.loss(leaf, x, y)
        (grad,) = torch.autograd.grad(loss, leaf)
        flat = flat - lr * grad
        params[step] = flat
        losses[step] = loss.detach()
    return params, losses


def pca_plane(trajectory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The first two principal components of the (n_steps, P) trajectory, as
    sklearn's ``PCA(n_components=2)`` defines them: the top right singular
    vectors of the centred trajectory, each flipped so that its entry of
    largest magnitude is positive (``svd_flip(u_based_decision=False)``).
    The SVD goes through a thin QR of the (P, n_steps) transpose and the SVD
    of its n_steps x n_steps R, in float64 on the trajectory's device;
    returned in float32."""
    centred = trajectory.double()
    centred = centred - centred.mean(dim=0)
    q, r = torch.linalg.qr(centred.T)  # centred = rᵀ qᵀ
    _, _, wh = torch.linalg.svd(r.T)  # rᵀ = u s wh, so centred = u s (wh qᵀ)
    comps = wh[:2] @ q.T
    largest = comps.abs().argmax(dim=1, keepdim=True)
    comps = comps * comps.gather(1, largest).sign()
    return comps[0].float(), comps[1].float()


def draw_signs(shape, seed: int) -> torch.Tensor:
    """The feature plane's random ±1 vector, from a ``torch.Generator`` seeded
    with ``seed`` (drawn on the CPU)."""
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).sign()


def feature_plane(component: Component, feat_input: torch.Tensor,
                  signs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The unit gradient of ‖f(x)‖ at the component's input ``feat_input``,
    and ``signs`` made orthogonal to it and unit."""
    feat = feat_input.detach().requires_grad_()
    (f_dx,) = torch.autograd.grad(torch.linalg.vector_norm(component.forward(feat)), feat)
    f_dx = f_dx / torch.linalg.vector_norm(f_dx)
    f_dy = signs.to(f_dx.device, f_dx.dtype)
    f_dy = f_dy - torch.sum(f_dy * f_dx) * f_dx
    return f_dx, f_dy / torch.linalg.vector_norm(f_dy)


def surface_point(component: Component, plane: Plane, u: float, v: float,
                  f_x: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss, rate of change) at (u, v), as 0-d float32 tensors on the
    plane's device. ``u`` and ``v`` are rounded to float32 first, as the JAX
    package's grid is."""
    u, v = float(np.float32(u)), float(np.float32(v))
    with torch.no_grad():
        z_loss = component.loss(plane.sub0 + u * plane.p_dx + v * plane.p_dy, plane.x, plane.y)
        delta = u * plane.f_dx + v * plane.f_dy
        dist_in = torch.linalg.vector_norm(delta).clamp_min(1e-8)
        if f_x is None:
            f_x = component.forward(plane.feat_input)
        f_y = component.forward(plane.feat_input + delta)
        z_func = (torch.linalg.vector_norm(f_y - f_x) / dist_in).clamp_min(1e-8)
    return z_loss, z_func


def surface_grid(component: Component, plane: Plane, u_coords, v_coords):
    """Both surfaces, (len(v_coords), len(u_coords)) host arrays with row j at
    v_coords[j]: the grid points one after another on the device, each
    surface copied to the host once."""
    with torch.no_grad():
        f_x = component.forward(plane.feat_input)
    z = torch.empty((2, len(v_coords) * len(u_coords)), device=plane.sub0.device)
    points = ((u, v) for v in v_coords for u in u_coords)  # row-major (j, i)
    for index, (u, v) in enumerate(points):
        z[0, index], z[1, index] = surface_point(component, plane, u, v, f_x=f_x)
    z_loss, z_func = z.cpu().numpy()
    shape = (len(v_coords), len(u_coords))
    return z_loss.reshape(shape), z_func.reshape(shape)


def get_pca_basis(model, block: int, comp: str, x_batch, y_batch, n_steps: int, lr: float):
    """The PCA plane of a short SGD trajectory in the component's parameter
    space: ``(dx, dy, sub0, component, (params, losses))``."""
    component = Component(model, block, comp)
    params, losses = sgd_trajectory(component, x_batch, y_batch, n_steps, lr)
    dx, dy = pca_plane(params)
    return dx, dy, component.sub0, component, (params, losses)


def compute_landscape(model, x_batch, y_batch, trainable_component: str, block: int,
                      n_steps: int, lr: float, resolution: int, grid_range: float,
                      seed: int = 42, signs: torch.Tensor | None = None) -> Landscape:
    """The surfaces and the trajectory of one component on one batch, on the
    model's device. ``signs`` (the shape of one input of the component, as
    the JAX package draws it) defaults to :func:`draw_signs` of ``seed``."""
    p_dx, p_dy, sub0, component, (params, losses) = get_pca_basis(
        model, block, trainable_component, x_batch, y_batch, n_steps=n_steps, lr=lr)

    with torch.no_grad():
        feat_input = model.module.embedding(x_batch)[0:1]
    if signs is None:
        signs = draw_signs(feat_input.shape, seed)
    f_dx, f_dy = feature_plane(component, feat_input, signs)
    plane = Plane(x=x_batch, y=y_batch, sub0=sub0, p_dx=p_dx, p_dy=p_dy,
                  feat_input=feat_input, f_dx=f_dx, f_dy=f_dy)

    u_coords = np.linspace(-grid_range, grid_range, resolution)
    v_coords = np.linspace(-grid_range, grid_range, resolution)
    Z_loss, Z_func = surface_grid(component, plane, u_coords, v_coords)

    # the trajectory on the PCA plane
    coords = ((params - sub0) @ torch.stack([p_dx, p_dy]).T).cpu().numpy()
    trajectory = [(float(a), float(b)) for a, b in coords]
    for step, loss in enumerate(losses.cpu().numpy()):
        print(f"Step {step + 1}/{n_steps}: Loss={float(loss):.4f}")
    return Landscape(Z_loss=Z_loss, Z_func=Z_func, u_coords=u_coords, v_coords=v_coords,
                     trajectory=trajectory, component=component, plane=plane, params=params,
                     losses=losses)


def get_rates_of_change(dataset_name: str, batch_size: int, trainable_component: str,
                        block: int, n_steps: int, lr: float, resolution: int,
                        grid_range: float, data_dir: str | None = None, model=None,
                        batch=None, seed: int = 42, device: str = "cuda",
                        signs: torch.Tensor | None = None):
    """``(Z_loss, Z_func, u_coords, v_coords, trajectory)`` of one component:
    ViT-B/16 (pretrained weights when cached, else random from ``seed``) on
    the first test batch of ``dataset_name``, unless ``model`` and ``batch``
    are given (``(x, y)`` as numpy arrays or tensors)."""
    device = resolve_device(device)
    set_seed(seed)
    if model is None:
        model = build_model(
            {"implementation": "vit", "model_name": "base", "pretrained": True,
             "in21k": False, "patch_size": 16, "image_dim": (3, 224, 224)},
            device=device, generator=torch.Generator().manual_seed(seed))
    if batch is None:
        loader_config = {"dataset_name": dataset_name, "batch_size": batch_size,
                         "mode": "test", "size": model.config.image_dim[-1]}
        if data_dir:
            loader_config["save_dir"] = data_dir
        x_batch, y_batch = next(iter(build_loader(loader_config, device=device)))
    else:
        x_batch, y_batch = (torch.as_tensor(t, device=device) for t in batch)
    result = compute_landscape(model, x_batch, y_batch, trainable_component, block,
                               n_steps, lr, resolution, grid_range, seed=seed, signs=signs)
    return (result.Z_loss, result.Z_func, result.u_coords, result.v_coords,
            result.trajectory)


def get_analysis(dataset_name: str = "cifar10", batch_size: int = 64,
                 trainable_component: str = "mha", block: int = 0, n_steps: int = 20,
                 lr: float = 1e-2, resolution: int = 25, grid_range: float = 1.0,
                 **kwargs) -> None:
    """Compute and pickle one component's surfaces."""
    Z_loss, Z_func, u_coords, v_coords, trajectory = get_rates_of_change(
        dataset_name=dataset_name, batch_size=batch_size,
        trainable_component=trainable_component, block=block, n_steps=n_steps, lr=lr,
        resolution=resolution, grid_range=grid_range, **kwargs)
    save_dir = SAVE_DIR / f"{trainable_component}_block_{block}"
    save_dir.mkdir(exist_ok=True, parents=True)
    logger.info(f"Saving results in {save_dir}.")
    for name, obj in [("loss", Z_loss), ("func", Z_func), ("u_coords", u_coords),
                      ("v_coords", v_coords), ("traj", trajectory)]:
        with open(save_dir / f"{name}.pkl", "wb") as f:
            pickle.dump(obj, f)


# ----------------------------------------------------------------------------
# Rendering
# ----------------------------------------------------------------------------


def _load_surfaces(trainable_component: str, block: int):
    save_dir = SAVE_DIR / f"{trainable_component}_block_{block}"
    out = {}
    for name in ("loss", "func", "u_coords", "v_coords", "traj"):
        with open(save_dir / f"{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return out


def save_plot(figname: str, folder: str | None = None, format: str = "pdf", dpi: int = 100):
    import matplotlib.pyplot as plt

    figure_path = FIGURE_DIR / "loss_landscape"
    if folder:
        figure_path = figure_path / folder
    figure_path.mkdir(parents=True, exist_ok=True)
    out = figure_path / f"{figname}.{format}"
    plt.savefig(out, format=format, bbox_inches="tight", dpi=dpi)
    return out


def get_results(trainable_component: str = "mha", block: int = 0, save: bool = True) -> None:
    """Contour plots of the loss and rate-of-change surfaces with the SGD
    trajectory drawn over them."""
    from .common import set_style

    set_style()
    import matplotlib.pyplot as plt

    data = _load_surfaces(trainable_component, block)
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    for ax, key, title in [(axes[0], "loss", "Loss Landscape"),
                           (axes[1], "func", "Rate of Change")]:
        Z = np.asarray(data[key])
        cs = ax.contourf(data["u_coords"], data["v_coords"], Z, levels=30, cmap="viridis")
        fig.colorbar(cs, ax=ax)
        traj = np.asarray(data["traj"])
        if len(traj):
            ax.plot(traj[:, 0], traj[:, 1], "w.-", lw=1.5, markersize=4,
                    label="SGD trajectory")
            ax.legend(fontsize=9)
        ax.set_title(f"{title} — {trainable_component.upper()} block {block}")
        ax.set_xlabel("u")
        ax.set_ylabel("v")
    plt.tight_layout()
    if save:
        save_plot(f"{trainable_component}_block_{block}")
    plt.close(fig)


def save_results(dataset_name: str = "cifar10", batch_size: int = 4, n_steps: int = 20,
                 lr: float = 1e-3, resolution: int = 20, grid_range: float = 0.5,
                 block: int = 0, data_dir: str | None = None, device: str = "cuda") -> None:
    """The ``save`` command: the surfaces of ln1, fc1 and mha at ``block``
    with the paper's settings."""
    for trainable_component in ["ln1", "fc1", "mha"]:
        get_analysis(dataset_name=dataset_name, batch_size=batch_size,
                     trainable_component=trainable_component, block=block, n_steps=n_steps,
                     lr=lr, resolution=resolution, grid_range=grid_range,
                     data_dir=data_dir, device=device)


def plot_figures(save: bool = True, block: int = 0) -> None:
    """The paper's figure, ``loss_landscape.pdf``: the rate-of-change
    surfaces of LN1 and MHA in 3-D (over their shared maximum) above the loss
    contours with the SGD trajectory."""
    from .common import set_style

    set_style()
    import matplotlib.pyplot as plt

    ln1 = _load_surfaces("ln1", block)
    mha = _load_surfaces("mha", block)
    row1_max = max(np.asarray(ln1["func"]).max(), np.asarray(mha["func"]).max())

    fig = plt.figure(figsize=(8, 8))
    for col, (name, data) in enumerate([("LN1", ln1), ("MHA", mha)]):
        U, V = np.meshgrid(data["u_coords"], data["v_coords"])
        ax3d = fig.add_subplot(2, 2, 1 + col, projection="3d")
        ax3d.plot_surface(U, V, np.asarray(data["func"]) / row1_max, cmap="viridis",
                          linewidth=0)
        ax3d.set_title(name)
        ax3d.set_zlim(0, 1)

        ax = fig.add_subplot(2, 2, 3 + col)
        cs = ax.contourf(data["u_coords"], data["v_coords"], np.asarray(data["loss"]),
                         levels=30, cmap="viridis")
        traj = np.asarray(data["traj"])
        if len(traj):
            ax.plot(traj[:, 0], traj[:, 1], "w.-", lw=1.5, markersize=4,
                    label="SGD trajectory")
            leg = ax.legend(fontsize=9, frameon=False)
            for text in leg.get_texts():
                text.set_color("white")
        if col == 0:
            ax.set_ylabel("Loss Landscape")
        else:
            fig.colorbar(cs, ax=ax)
    plt.tight_layout()
    if save:
        save_plot("loss_landscape")
    plt.close(fig)


def get_frames(trainable_component: str = "mha", block: int = 0, n_frames: int = 12) -> list:
    """Rotating 3-D surface frames (png) for a gif."""
    from .common import set_style

    set_style()
    import matplotlib.pyplot as plt

    data = _load_surfaces(trainable_component, block)
    U, V = np.meshgrid(data["u_coords"], data["v_coords"])
    Z = np.asarray(data["func"])
    paths = []
    for i in range(n_frames):
        fig = plt.figure(figsize=(5, 4))
        ax = fig.add_subplot(111, projection="3d")
        ax.plot_surface(U, V, Z, cmap="viridis", linewidth=0)
        ax.view_init(elev=30, azim=360 * i / n_frames)
        ax.set_title(f"{trainable_component.upper()} block {block}")
        paths.append(save_plot(f"frame_{i:03d}", folder=f"{trainable_component}_block_{block}",
                               format="png"))
        plt.close(fig)
    return paths


def get_latex_frames(trainable_component: str = "mha", block: int = 0,
                     n_frames: int = 4) -> list:
    """Frames for inclusion in the paper."""
    return get_frames(trainable_component, block, n_frames=n_frames)


def plot_gif(trainable_component: str = "mha", block: int = 0, n_frames: int = 12,
             fps: int = 8) -> None:
    """The rotating-surface frames assembled into a gif."""
    import imageio.v2 as imageio

    paths = get_frames(trainable_component, block, n_frames=n_frames)
    frames = [imageio.imread(p) for p in paths]
    out = FIGURE_DIR / "loss_landscape" / f"{trainable_component}_block_{block}.gif"
    imageio.mimsave(out, frames, fps=fps)
    logger.info("Wrote %s", out)


def main(argv: list[str] | None = None) -> None:
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(filename)s:%(lineno)d - %(message)s",
        handlers=[logging.StreamHandler()])
    make_cli({"save": save_results, "plot": plot_figures, "results": get_results,
              "analysis": get_analysis, "latex": get_latex_frames, "frames": get_frames,
              "gif": plot_gif}, argv)


if __name__ == "__main__":
    main()

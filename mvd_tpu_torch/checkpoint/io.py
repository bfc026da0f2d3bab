"""The port's own checkpoints: train state, dataset state and metrics,
keeping the top k plus the latest step.

Counterpart of ``mvd_tpu/checkpoint/orbax_io.py`` (orbax does not carry
over; this is not an orbax checkpoint, and its ``meta.json`` says so in
``format``). A checkpoint is a directory ``<directory>/<step>/`` holding

* ``state.pt`` (``torch.save``): what the JAX ``TrainState`` holds — the
  step, every parameter and buffer of ``model["mvd"]`` as ``TrainState``
  keeps them (f32 trainable masters, the frozen ones in the compute dtype
  ``TrainState.create`` cast them to), the AdamW state, and with gradient
  accumulation the running mean, its count and the count of updates;
* ``meta.json``: ``format``, ``step``, ``metrics``, ``dataset_state``,
  ``wandb_run_id`` and any other extras.

A save is written under a temporary name and renamed into place, so a
killed job never leaves a half checkpoint that ``latest_step`` would pick.
Retention is Lightning's ``save_top_k`` + ``save_last``: the
``max_to_keep`` best by ``monitor`` (a save without that metric never takes
a top-k slot) plus always the latest step. A save of a step the port
already wrote replaces it. A restore into a ``TrainState`` built the same way is
bitwise.

The manager also reads the step dirs the JAX package's ``CheckpointManager``
writes with orbax into the same layout (``<directory>/<step>/`` holding
``state/``, ``meta/metadata`` and ``metrics/metrics``;
``orbax_read.read_step``): ``all_steps``, ``latest_step`` and ``best_step``
count them beside the port's own, and ``restore`` of one goes through
``from_jax.carry_jax_train_state``, so ``--resume`` continues a JAX run. It
writes only its own format, and never removes or replaces a step dir it
did not write: a save that collides with one raises, and retention leaves
such dirs alone.

``save_params`` writes ``<path>/params.pt``; ``load_params_into`` and
``load_component`` read that or a directory the JAX package's
``save_params`` wrote with orbax.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..tensor_parallel import refuse_sharded

logger = logging.getLogger(__name__)

FORMAT = "mvd_tpu_torch.checkpoint.io/1"
STATE_FILE, META_FILE = "state.pt", "meta.json"


def _state_payload(state) -> Dict[str, Any]:
    payload = {
        "step": state.step,
        "updates": state.updates,
        "params": state.model["mvd"].state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "mini_step": state.mini_step,
    }
    if state.acc is not None:
        payload["acc"] = state.acc
    return payload


def _load_payload(state, payload: Dict[str, Any]) -> None:
    mine = state.model["mvd"].state_dict()
    differ = set(mine) ^ set(payload["params"])
    if differ:
        raise KeyError(f"checkpoint and model parameters differ: {sorted(differ)[:10]}")
    for name, t in mine.items():
        src = payload["params"][name]
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"checkpoint parameter {name}: {tuple(src.shape)} {src.dtype} "
                             f"does not match the model's {tuple(t.shape)} {t.dtype}")
    state.model["mvd"].load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step, state.updates = int(payload["step"]), int(payload["updates"])
    state.mini_step = int(payload["mini_step"])
    state.acc = payload.get("acc")
    if state.acc is not None:
        dev = next(iter(state.trainable.values())).device
        state.acc = {k: v.to(dev) for k, v in state.acc.items()}


def _step_dirs(directory: str) -> List[int]:
    """The port's own steps under ``directory``."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(e) for e in os.listdir(directory)
                  if e.isdigit() and os.path.isfile(os.path.join(directory, e, META_FILE)))


def _all_steps(directory: str) -> List[int]:
    """The port's steps and the JAX package's orbax steps under ``directory``."""
    from .orbax_read import orbax_steps

    return sorted(set(_step_dirs(directory)) | set(orbax_steps(directory)))


def _writer(step_dir: str) -> Optional[str]:
    """Who wrote an existing step dir: None for the port, else a name."""
    from .orbax_read import is_orbax_step

    if os.path.isfile(os.path.join(step_dir, META_FILE)):
        return None
    if is_orbax_step(step_dir):
        return "the JAX package's CheckpointManager (orbax)"
    return "an unknown writer (it holds no meta.json of this port)"


def _read_meta(step_dir: str) -> Dict[str, Any]:
    """The meta of a step of either format: the port's ``meta.json``, or
    the JAX step's ``meta/metadata`` with its ``metrics/metrics``."""
    from .orbax_read import read_json_item

    if _writer(step_dir) is None:
        with open(os.path.join(step_dir, META_FILE)) as f:
            return json.load(f)
    meta = dict(read_json_item(step_dir, "meta") or {})
    meta.update(format="orbax", step=int(os.path.basename(step_dir)),
                metrics=read_json_item(step_dir, "metrics") or {})
    return meta


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, monitor: str = "val/noise_loss",
                 mode: str = "min", save_interval_steps: int = 1000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.monitor = monitor
        self.save_interval_steps = save_interval_steps
        self._sign = -1.0 if mode == "min" else 1.0

    def _rank(self, metrics: Optional[Dict[str, float]]) -> float:
        """Higher is better; a save without the monitored metric ranks last."""
        if metrics and self.monitor in metrics:
            return self._sign * float(metrics[self.monitor])
        return float("-inf")

    def _metrics(self, step: int) -> Dict[str, float]:
        return _read_meta(os.path.join(self.directory, str(step))).get("metrics") or {}

    def save(self, step: int, state, dataset_state: Optional[Dict] = None,
             extra: Optional[Dict[str, Any]] = None, metrics: Optional[Dict[str, float]] = None,
             force: bool = False) -> bool:
        """Write ``state`` as ``step`` (off the save interval only with
        ``force``), then drop what retention no longer keeps. Returns
        whether it saved."""
        if not force and self.save_interval_steps and step % self.save_interval_steps:
            return False
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final) and _writer(final) is not None:
            raise FileExistsError(f"checkpoint step dir {final} was written by {_writer(final)}; the "
                                  "port does not replace it (resume from it, or train into another "
                                  "output dir)")
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(_state_payload(state), os.path.join(tmp, STATE_FILE))
        meta = {"format": FORMAT, "step": step,
                "metrics": {k: float(v) for k, v in (metrics or {}).items()}, **(extra or {})}
        if dataset_state is not None:
            meta["dataset_state"] = dataset_state
        with open(os.path.join(tmp, META_FILE), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            logger.warning("checkpoint step %d already exists under %s; replacing it",
                           step, self.directory)
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._collect()
        return True

    def _collect(self) -> None:
        """Drop the port's steps that retention no longer keeps; step dirs
        of other writers are neither counted nor touched."""
        steps = _step_dirs(self.directory)
        if not steps:
            return
        ranked = [(self._rank(self._metrics(s)), s) for s in steps]
        best = sorted((r for r in ranked if r[0] > float("-inf")), key=lambda r: -r[0])
        keep = {s for _, s in best[:self.max_to_keep]} | {steps[-1]}
        for s in steps:
            if s not in keep:
                shutil.rmtree(os.path.join(self.directory, str(s)))

    def latest_step(self) -> Optional[int]:
        steps = _all_steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """The port's steps and the JAX package's, ascending."""
        return _all_steps(self.directory)

    def best_step(self) -> Optional[int]:
        """The kept step (of either format) with the best monitored metric,
        if any has it."""
        ranked = [(self._rank(self._metrics(s)), s) for s in _all_steps(self.directory)]
        ranked = [r for r in ranked if r[0] > float("-inf")]
        return max(ranked)[1] if ranked else None

    def restore(self, state, step: Optional[int] = None) -> Tuple[Any, Optional[Dict]]:
        """Load ``step`` (the latest by default, of either format) into
        ``state`` in place; returns (state, meta), or (None, None) when
        there is no checkpoint. A JAX step's meta is its ``meta/metadata``
        (``dataset_state``, ``wandb_run_id``) with ``metrics``, ``step``
        and ``format`` "orbax"."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        step_dir = os.path.join(self.directory, str(step))
        if not os.path.isdir(step_dir):
            raise FileNotFoundError(f"no checkpoint step {step} under {self.directory}")
        writer = _writer(step_dir)
        if writer is not None:
            from .from_jax import carry_jax_train_state
            from .orbax_read import is_orbax_step, read_step

            if not is_orbax_step(step_dir):
                raise ValueError(f"{step_dir} was written by {writer}; it does not restore")
            tree, _, _ = read_step(step_dir, lazy=True)
            carry_jax_train_state(state, tree)
            return state, _read_meta(step_dir)
        meta = _read_meta(step_dir)
        if meta.get("format") != FORMAT:
            raise ValueError(f"{step_dir} is not a checkpoint of this port (format "
                             f"{meta.get('format')!r}, expected {FORMAT!r})")
        payload = torch.load(os.path.join(step_dir, STATE_FILE), map_location="cpu",
                             weights_only=True)
        _load_payload(state, payload)
        return state, meta

    def wait(self):
        """Saves are synchronous; nothing to wait for."""


def resolve_resume_path(path: str) -> Tuple[str, Optional[int]]:
    """A ``--resume`` path as (checkpoints dir, pinned step or None): a run
    dir with a ``checkpoints/`` subdirectory, that directory itself (named
    ``checkpoints`` or holding numeric step dirs), or one step dir in it.
    Anything else raises ``FileNotFoundError``: a typo'd resume must never
    start a fresh run somewhere unexpected."""
    p = os.path.abspath(path)
    if not os.path.isdir(p):
        raise FileNotFoundError(f"--resume path does not exist or is not a directory: {path}")
    base = os.path.basename(p.rstrip(os.sep))
    if base.isdigit():
        return os.path.dirname(p), int(base)
    sub = os.path.join(p, "checkpoints")
    if os.path.isdir(sub):
        return sub, None
    if base == "checkpoints" or any(
        e.isdigit() and os.path.isdir(os.path.join(p, e)) for e in os.listdir(p)
    ):
        return p, None
    raise FileNotFoundError(
        f"--resume path {path} is neither a run dir (no checkpoints/ subdir), a checkpoints "
        "dir (no numeric step dirs), nor a step dir")


def peek_checkpoint_meta(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The meta of the latest (or the given, or the pinned) step under a
    resume path, of either format, without loading the state; {} when there
    is none."""
    ckpt_dir, pinned = resolve_resume_path(path)
    step = step if step is not None else pinned
    if step is None:
        steps = _all_steps(ckpt_dir)
        if not steps:
            return {}
        step = steps[-1]
    try:
        return _read_meta(os.path.join(ckpt_dir, str(step)))
    except (OSError, ValueError) as e:
        logger.warning("could not read checkpoint meta under %s: %s", path, e)
        return {}


PARAMS_FILE = "params.pt"


def save_params(path: str, params: Dict[str, Dict[str, torch.Tensor]],
                config_json: Optional[str] = None):
    """Component state dicts ({"vae": ..., "text_encoder": ..., "mvd": ...})
    to ``<path>/params.pt`` (for ``--init-params`` and exports)."""
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save({"format": FORMAT, "params": params}, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))
    if config_json:
        with open(os.path.join(path, "mvd_config.json"), "w") as f:
            f.write(config_json)


def load_params(path: str) -> Dict[str, Dict[str, torch.Tensor]]:
    """What ``save_params`` wrote."""
    blob = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)
    if blob.get("format") != FORMAT:
        raise ValueError(f"{path} was not written by save_params of this port")
    return blob["params"]


_ZARR_DTYPES = {torch.float32: "<f4", torch.bfloat16: "bfloat16", torch.float16: "<f2"}


def load_jax_component(module: torch.nn.Module, tree, where: str) -> None:
    """One component's flax tree read from an orbax dir (lazy leaves) into
    ``module``, 1:1 (``from_jax.load_jax_params``), each leaf's dtype the
    parameter's, as the JAX package's ``load_params`` with its template
    requires. A mismatch raises ``ValueError`` naming it."""
    from .from_jax import _plan, load_jax_params

    params = dict(module.named_parameters())
    for name, (leaf, _) in _plan(tree).items():
        want = _ZARR_DTYPES.get(params[name].dtype) if name in params else None
        if want is not None and getattr(leaf, "dtype", want) != want:
            raise ValueError(f"{where}: {name} is {leaf.dtype} in the checkpoint, {want} in the model")
    try:
        load_jax_params(module, tree)
    except KeyError as e:
        raise ValueError(f"{where} does not match the configured architecture: {e}") from None


def _orbax_components(path: str) -> Dict:
    from .orbax_read import read_tree

    tree = read_tree(path, lazy=True)
    if not isinstance(tree, dict):
        raise ValueError(f"{path}: an orbax tree of components (vae / text_encoder / mvd) expected")
    return tree


def load_params_into(pipe, path: str) -> List[str]:
    """Load a ``save_params`` directory (the port's ``params.pt``, or the
    JAX package's orbax directory) into ``pipe``'s networks, component by
    component (``vae`` / ``text_encoder`` / ``mvd``); a component the
    directory lacks keeps its weights. A component the pipeline lacks, or
    whose names, shapes or dtypes differ from the configured architecture,
    raises, as do model-sharded networks. Returns the components loaded."""
    from .orbax_read import is_orbax_dir

    refuse_sharded(pipe.model, f"loading {path}")
    loaded = []
    if is_orbax_dir(path):
        for comp, tree in _orbax_components(path).items():
            if comp not in pipe.model:
                raise ValueError(f"{path}: component {comp!r} not in the pipeline (have {sorted(pipe.model)})")
            load_jax_component(pipe.model[comp], tree, f"{path}: component {comp!r}")
            loaded.append(comp)
        pipe.drop_compute_model()
        return loaded
    for comp, sd in load_params(path).items():
        if comp not in pipe.model:
            raise ValueError(f"{path}: component {comp!r} not in the pipeline (have {sorted(pipe.model)})")
        want = {k: (tuple(v.shape), v.dtype) for k, v in pipe.model[comp].state_dict().items()}
        got = {k: (tuple(v.shape), v.dtype) for k, v in sd.items()}
        if want != got:
            raise ValueError(f"{path}: component {comp!r} does not match the configured architecture "
                             "(names, shapes or dtypes)")
        pipe.model[comp].load_state_dict(sd)
        loaded.append(comp)
    pipe.drop_compute_model()
    return loaded


def load_component(module: torch.nn.Module, path: str, comp: str) -> None:
    """Load component ``comp`` of a ``save_params`` directory (the port's,
    or the JAX package's orbax one) into ``module``; a directory without it
    raises ``ValueError``."""
    from .orbax_read import is_orbax_dir

    refuse_sharded(module, f"loading {path}")
    comps = _orbax_components(path) if is_orbax_dir(path) else load_params(path)
    if comp not in comps:
        raise ValueError(f"{path}: no {comp!r} component (have {sorted(comps)})")
    if is_orbax_dir(path):
        load_jax_component(module, comps[comp], f"{path}: component {comp!r}")
    else:
        module.load_state_dict(comps[comp])

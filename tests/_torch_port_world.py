"""A ``gloo`` world of CPU processes for the port's multi-process tests.

``World(n, scenario, workdir)`` starts ``n`` processes of this file, and
``spawn`` waits for them. Each joins the process group
(``mvd_tpu_torch.distributed.initialize`` with ``backend="gloo"``,
``device="cpu"``), runs ``SCENARIOS[scenario]`` with its rank and
``workdir`` (inputs in, results out, as files) and leaves the group. The
processes import torch and the port only, never JAX: the test process
computes the JAX side meanwhile and compares.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """``n`` processes running one scenario; ``wait`` collects them."""

    def __init__(self, n: int, scenario: str, workdir: str):
        ports = ",".join(str(_free_port()) for _ in range(3))
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
            p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
        self.procs = [subprocess.Popen([sys.executable, __file__, scenario, str(r), str(n), ports, workdir],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                                       env=env)
                      for r in range(n)]

    def wait(self, timeout: float = 240.0) -> None:
        """Raises with the failing ranks' output when one exits non-zero or
        the world outlives ``timeout`` seconds; every process is gone after."""
        outs = []
        try:
            for p in self.procs:
                outs.append(p.communicate(timeout=timeout)[0])
        finally:
            self.kill()
        failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(self.procs, outs))
                  if p.returncode]
        if failed:
            raise AssertionError("\n".join(f"rank {r} exited {rc}:\n{out[-4000:]}" for r, rc, out in failed))

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def spawn(n: int, scenario: str, workdir: str, timeout: float = 240.0) -> None:
    """Run ``scenario`` in a world of ``n`` processes to its end."""
    World(n, scenario, workdir).wait(timeout)


# ---------------------------------------------------------------------------
# scenarios: (rank, world, workdir) -> None
# ---------------------------------------------------------------------------


def ring(rank: int, world: int, workdir: str) -> None:
    """The ring over the whole world, forward and backward, on the shards
    of ``ring_in.pt``; writes ``ring_out{rank}.pt``."""
    import torch

    from mvd_tpu_torch.kernels.ring_attention import ring_bwd, ring_fwd
    from mvd_tpu_torch.mesh import make_mesh

    inp = torch.load(os.path.join(workdir, "ring_in.pt"))
    heads = inp["heads"]
    q, k, v, do = (inp[n][rank] for n in ("q", "k", "v", "do"))
    mesh = make_mesh(view=world)
    axis = mesh.axis("view")
    out, lse = ring_fwd(q, k, v, heads, axis)
    dq, dk, dv = ring_bwd(q, k, v, out, lse, do, heads, axis)
    torch.save(dict(out=out, lse=lse, dq=dq, dk=dk, dv=dv), os.path.join(workdir, f"ring_out{rank}.pt"))


def _tensor(x):
    import numpy as np
    import torch

    return torch.from_numpy(np.array(x))


def _tree_to_torch(tree):
    from mvd_tpu_torch.parallel import tree_map

    return tree_map(_tensor, tree)


def sharded(rank: int, world: int, workdir: str) -> None:
    """Every check of ``test_torch_port_sharded.py`` that runs on a mesh of
    4 (data 2 x view 2) on the inputs of ``sharded_in.pt``: the sharded
    denoise (this rank's block), the sharded sampler beside the unsharded
    loop on rank 0, the sharded pipeline (images), the
    data-parallel step on a mesh of data 2 (ranks 0 and 1) and the
    view-sharded step, beside the unsharded joint step on rank 0. Writes
    ``sharded_out{rank}.pt``."""
    import torch

    from mvd_tpu_torch.config import TrainConfig
    from mvd_tpu_torch.diffusion.schedules import ddpm_step, inference_timesteps
    from mvd_tpu_torch.mesh import make_mesh
    from mvd_tpu_torch.parallel import for_view_sharding, make_sharded_sampler, sharded_denoise_fn, tree_map
    from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
    from mvd_tpu_torch.pipeline.pipeline import build_model
    from mvd_tpu_torch.train import TrainState, make_train_step

    inp = torch.load(os.path.join(workdir, "sharded_in.pt"), weights_only=False)
    cfg, tree = inp["cfg"], inp["tree"]
    V = cfg.unet.num_views
    cfg_s = for_view_sharding(cfg, V, 2)
    mesh = make_mesh(data=2, view=2)
    mesh_dp = make_mesh(data=2)  # ranks 0 and 1; every rank makes its groups
    out = {}

    pipe = MVDPipeline(cfg_s, build_model(cfg_s), "cpu", mesh=mesh)
    pipe.load_jax_params(tree)
    mvd = pipe.model["mvd"]
    d = _tree_to_torch(inp["denoise"])
    n = d["text"].shape[0]
    bv = lambda t: tree_map(lambda x: x.reshape((n // V, V) + tuple(x.shape[1:])), t)
    bv_steps = lambda x: x.reshape((x.shape[0], n // V, V) + tuple(x.shape[2:]))
    with torch.no_grad():
        film, refs = mvd.prepare_conditioning(d["text"], d["src_cam"], d["tgt_cam"], d["src_lat"],
                                              cfg_batch=n, precompute_kv=True)
        out["denoise"] = sharded_denoise_fn(mvd, mesh)(bv(d["lat"]), torch.tensor(600), bv(d["text"]),
                                                        bv(film), bv(refs), 0.7)
        # make_sharded_sampler: 2 DDPM steps at the given noise, against the
        # unsharded loop on rank 0
        sched, noises = pipe.schedule, d["step_noises"]
        out["sampler"] = make_sharded_sampler(mvd, mesh, sched, 2)(
            bv(d["lat"]), bv(d["text"]), bv(film), bv(refs), 0.7, step_noises=bv_steps(noises))
        if rank == 0:
            lat = d["lat"]
            for i, t in enumerate(inference_timesteps(sched, 2).tolist()):
                pred = mvd.denoise(lat, torch.tensor(t), d["text"], film, refs, 0.7)
                lat = ddpm_step(sched, pred, t, lat, noises[i], 2)
            out["sampler_ref"] = lat
    for name, (prompts, kw) in inp["pipeline"].items():
        out[f"images/{name}"] = torch.from_numpy(pipe(prompts, **kw)["images"])

    tr = inp["train"]
    batch, draws = _tree_to_torch(tr["batch"]), tr["draws"]

    def train_step(model_cfg, step_mesh, view_sharded, block):
        model = build_model(model_cfg)
        model.load_state_dict(pipe.model.state_dict())
        tcfg = TrainConfig(model=model_cfg)
        state = TrainState.create(model, tcfg, 4)
        step = make_train_step(build_schedule(model_cfg), tcfg, mesh=step_mesh,
                               view_sharded=view_sharded)
        metrics = step(state, block, draws=draws)
        return {k: v for k, v in metrics.items() if not k.startswith("hist/")}

    if mesh_dp.member:
        out["dp"] = train_step(inp["cfg_dp"], mesh_dp, False, tree_map(mesh_dp.block, batch))
    out["vs"] = train_step(cfg_s, mesh, True, tree_map(mesh.block, batch))
    if rank == 0:
        out["vs_ref"] = train_step(cfg, None, False, batch)
    torch.save(out, os.path.join(workdir, f"sharded_out{rank}.pt"))


def trainer(rank: int, world: int, workdir: str, ports) -> None:
    """``cli.train`` with ``--mesh-data 2`` and the process flags (it joins
    the group itself): 2 steps and a validation, then ``--resume`` to step
    3 under a fresh group; then one view-sharded step (``--mesh-view 2
    --num-views 2``) and a validation. Writes ``trainer_out{rank}.pt``."""
    import torch

    from mvd_tpu_torch.cli import train

    corpus = os.path.join(workdir, "corpus")
    common = ["--tiny", "--device", "cpu", "--dataset-path", corpus, "--batch-size", "1",
              "--mesh-data", "2", "--num-processes", str(world), "--process-id", str(rank),
              "--output-dir", os.path.join(workdir, "run")]
    tr = train.main(common + ["--coordinator", f"127.0.0.1:{ports[1]}", "--max-steps", "2"])
    first = dict(root=tr.dirs["root"], step=tr.state.step, loader_rows=tr.train_loader.batch_size)
    tr2 = train.main(common + ["--coordinator", f"127.0.0.1:{ports[2]}", "--resume", tr.dirs["root"],
                               "--max-steps", "3"])
    # the views of a sample over the 2 processes: ring attention in the step
    view = ["--tiny", "--device", "cpu", "--dataset-path", corpus, "--batch-size", "1",
            "--mesh-view", "2", "--num-views", "2", "--num-processes", str(world), "--process-id",
            str(rank), "--output-dir", os.path.join(workdir, "run_view"), "--coordinator",
            f"127.0.0.1:{ports[0]}", "--max-steps", "1"]
    tr3 = train.main(view)
    torch.save(dict(first=first, resumed_root=tr2.dirs["root"], resumed_step=tr2.state.step,
                    view=dict(step=tr3.state.step, sharded=tr3.view_sharded, mesh=tr3.mesh.shape,
                              axis=tr3.cfg.model.unet.view_axis)),
               os.path.join(workdir, f"trainer_out{rank}.pt"))


def _raised(fn) -> str:
    """The message of what ``fn()`` raises ("" where it returns)."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the tests read the type and the message
        return f"{type(e).__name__}: {e}"
    return ""


def _tp_grads(rank: int, mesh) -> dict:
    """A column -> row pair and a gathered column layer over the model axis
    of ``mesh``, forward and backward, against the same layers whole: the
    largest relative error of the input's gradient and of this rank's part
    of each weight's gradient."""
    import torch
    import torch.nn.functional as F

    from mvd_tpu_torch.nn.layers import Linear
    from mvd_tpu_torch.tensor_parallel import (
        ColumnParallelLinear,
        RowParallelLinear,
        cut,
        each,
        model_axis,
    )

    gen = torch.Generator().manual_seed(0)
    l1, l2, l3 = Linear(8, 16), Linear(16, 8), Linear(8, 12)
    for p in (*l1.parameters(), *l2.parameters(), *l3.parameters()):
        p.data = torch.randn(p.shape, generator=gen)
    x, c = torch.randn(3, 8, generator=gen), torch.randn(3, 12, generator=gen)
    axis = model_axis(mesh)
    s1, s2 = ColumnParallelLinear(l1, axis, gather=False), RowParallelLinear(l2, axis)
    s3 = ColumnParallelLinear(l3, axis, gather=True)
    xs, xw = x.clone().requires_grad_(), x.clone().requires_grad_()
    (s3(s2(each(F.silu, s1(xs)))) * c).sum().backward()
    (l3(l2(F.silu(l1(xw)))) * c).sum().backward()
    rel = lambda got, want: ((got - want).abs().max() / want.abs().max()).item()
    errs = {"input": rel(xs.grad, xw.grad)}
    for name, s, whole, dim in (("column", s1, l1, 0), ("row", s2, l2, 1), ("gathered", s3, l3, 0)):
        errs[name] = rel(s.weight.grad[0], cut(whole.weight.grad, dim, axis.size)[rank])
    return errs


def model_parallel(rank: int, world: int, workdir: str) -> None:
    """Every check of ``test_torch_port_model_parallel.py`` that needs the
    2 processes: the TINY UNet forward, a multi-view denoise with FiLM and
    precomputed adapter K/V and a CLIP encode, each over the gloo model
    axis of ``make_mesh(model=2)`` and, on rank 0, over 2 and 4 virtual
    ranks; 3 DDPM steps of the model-sharded pipeline; the collectives'
    gradients; and what must raise. Writes ``mp_out{rank}.pt``."""
    import copy

    import torch

    from mvd_tpu_torch.checkpoint import load_jax_params
    from mvd_tpu_torch.config import TrainConfig
    from mvd_tpu_torch.mesh import make_mesh
    from mvd_tpu_torch.nn import CLIPTextEncoder, MultiViewUNet, UNet2DCondition
    from mvd_tpu_torch.parallel import for_view_sharding, shard_params_model_parallel, sharded_denoise_fn
    from mvd_tpu_torch.pipeline import MVDPipeline, build_schedule
    from mvd_tpu_torch.pipeline.pipeline import build_model
    from mvd_tpu_torch.tensor_parallel import virtual_model_axis
    from mvd_tpu_torch.train import make_train_step

    inp = torch.load(os.path.join(workdir, "mp_in.pt"), weights_only=False)
    cfg, tree, min_dim = inp["cfg"], inp["tree"], inp["min_dim"]
    mesh, mesh_view = make_mesh(model=2), make_mesh(view=2)  # every rank makes every group
    axes = {"gloo 2": mesh}
    if rank == 0:
        axes.update({"virtual 2": virtual_model_axis(2), "virtual 4": virtual_model_axis(4)})

    def over_axes(whole, run):
        with torch.no_grad():
            return {key: run(shard_params_model_parallel(copy.deepcopy(whole), axis, min_dim))
                    for key, axis in axes.items()}

    def loaded(module, sub):
        load_jax_params(module, sub)
        return module

    u = _tree_to_torch(inp["unet_in"])
    out = {"unet": over_axes(loaded(UNet2DCondition(cfg.unet), inp["unet_tree"]),
                             lambda m: m(u["sample"], u["t"], u["ctx"])[0])}
    d = _tree_to_torch(inp["denoise"])
    n = d["text"].shape[0]

    def denoise(m):
        film, refs = m.prepare_conditioning(d["text"], d["src_cam"], d["tgt_cam"], d["src_lat"],
                                            cfg_batch=n, precompute_kv=True)
        return m.denoise(d["lat"], torch.tensor(600), d["text"], film, refs, 0.7)

    mvd = loaded(MultiViewUNet(cfg), tree["mvd"])
    out["denoise"] = over_axes(mvd, denoise)
    out["clip"] = over_axes(loaded(CLIPTextEncoder(cfg.text_encoder), tree["text_encoder"]),
                            lambda m: m(d["ids"]))

    pipe = MVDPipeline(cfg, build_model(cfg), "cpu", mesh=mesh)
    pipe.load_jax_params(tree)
    out["unsharded_pipeline_raises"] = _raised(lambda: pipe(inp["pipeline"][0], **inp["pipeline"][1]))
    shard_params_model_parallel(pipe.model, mesh, min_dim)
    out["images"] = torch.from_numpy(pipe(inp["pipeline"][0], **inp["pipeline"][1])["images"])
    out["grads"] = _tp_grads(rank, mesh)

    out["train_step_raises"] = _raised(
        lambda: make_train_step(build_schedule(cfg), TrainConfig(model=cfg), mesh=mesh))
    # a view-sharded call of a model-sharded network
    V = 2
    cfg_v = for_view_sharding(cfg, V, 2)
    joint = shard_params_model_parallel(loaded(MultiViewUNet(cfg_v), tree["mvd"]),
                                        virtual_model_axis(2), min_dim)
    bv = lambda x: x.reshape((n // V, V) + tuple(x.shape[1:]))
    with torch.no_grad():
        out["view_x_model_raises"] = _raised(lambda: sharded_denoise_fn(joint, mesh_view)(
            bv(d["lat"]), torch.tensor(600), bv(d["text"])))
    torch.save(out, os.path.join(workdir, f"mp_out{rank}.pt"))


def multislice(rank: int, world: int, workdir: str) -> None:
    """Every check of ``test_torch_port_multislice.py``: the rank tables of
    2-slice meshes grouped by a ``hosts`` list of two hosts and by the
    gathered hosts (one here, so contiguous), what must raise, the
    view-sharded denoise on 2-slice meshes of data 2 x view 2 beside the
    unsharded one, and ``cli.train --num-slices 2`` for one step on the
    corpus under ``workdir``. Writes ``multislice_out{rank}.pt``."""
    import numpy as np
    import torch

    from mvd_tpu_torch.cli import train
    from mvd_tpu_torch.config import TINY_MODEL
    from mvd_tpu_torch.mesh import make_mesh, mesh_from_shape
    from mvd_tpu_torch.parallel import for_view_sharding, sharded_denoise_fn, tree_map
    from mvd_tpu_torch.pipeline import MVDPipeline
    from mvd_tpu_torch.pipeline.pipeline import build_model

    interleaved = ["h0", "h1", "h0", "h1"]
    out = {
        "divisible": _raised(lambda: make_mesh(data=3, view=1, num_slices=2)),
        "too_few": _raised(lambda: make_mesh(data=4, num_slices=2, hosts=["a", "a", "a", "b"])),
        "from_shape": mesh_from_shape({"data": 4, "num_slices": 2}).shape,
    }
    meshes = {"two hosts": make_mesh(data=2, view=2, num_slices=2, hosts=interleaved),
              "one host": make_mesh(data=2, view=2, num_slices=2)}
    out["tables"] = {key: m.table for key, m in meshes.items()}
    model_mesh = make_mesh(data=2, model=2, num_slices=2, hosts=interleaved)
    out["model_line"] = model_mesh.axis("model").ranks
    out["view_x_model"] = _raised(lambda: MVDPipeline(TINY_MODEL, build_model(TINY_MODEL), "cpu",
                                                      mesh=make_mesh(view=2, model=2)))

    V, groups = 2, 2
    pipe = MVDPipeline.create(for_view_sharding(TINY_MODEL, V, 2), seed=0, device="cpu")
    whole = build_model(for_view_sharding(TINY_MODEL, V, 1))["mvd"]
    whole.load_state_dict(pipe.model["mvd"].state_dict())
    rng = np.random.default_rng(0)
    n, lat = groups * V, TINY_MODEL.unet.sample_size
    f32 = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    text, src_lat, x = f32(n, 77, TINY_MODEL.unet.cross_attention_dim), f32(n, lat, lat, 4), f32(n, lat, lat, 4)
    cam = torch.eye(4).repeat(n, 1, 1)
    cam[:, :3, 3] = f32(n, 3)
    bv = lambda tree: tree_map(lambda t: t.reshape((groups, V) + tuple(t.shape[1:])), tree)
    with torch.no_grad():
        film, refs = whole.prepare_conditioning(text, cam[:1].repeat(n, 1, 1), cam, src_lat, cfg_batch=n,
                                                precompute_kv=True)
        out["unsharded"] = whole.denoise(x, torch.tensor(500), text, film, refs, 0.7)
        out["sharded"] = {
            key: m.gather_blocks(sharded_denoise_fn(pipe.model["mvd"], m)(
                bv(x), torch.tensor(500), bv(text), bv(film), bv(refs), 0.7)).flatten(0, 1)
            for key, m in meshes.items()}

    tr = train.main(["--tiny", "--device", "cpu", "--dataset-path", os.path.join(workdir, "corpus"),
                     "--batch-size", "1", "--num-slices", "2", "--max-steps", "1",
                     "--output-dir", os.path.join(workdir, "run")])
    out["train"] = dict(step=tr.state.step, mesh=tr.mesh.shape, table=tr.mesh.table)
    torch.save(out, os.path.join(workdir, f"multislice_out{rank}.pt"))


SCENARIOS = {"ring": ring, "sharded": sharded, "model_parallel": model_parallel, "multislice": multislice}
SELF_JOINING = {"trainer": trainer}  # scenarios that join (and leave) the group themselves


def main(argv) -> None:
    scenario, rank, world, ports, workdir = argv
    rank, world, ports = int(rank), int(world), [int(p) for p in ports.split(",")]
    import torch

    torch.set_num_threads(1)
    if scenario in SELF_JOINING:
        SELF_JOINING[scenario](rank, world, workdir, ports)
        return
    from mvd_tpu_torch import distributed

    distributed.initialize(coordinator=f"127.0.0.1:{ports[0]}", num_processes=world, process_id=rank,
                           backend="gloo", device="cpu")
    try:
        SCENARIOS[scenario](rank, world, workdir)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(sys.argv[1:])

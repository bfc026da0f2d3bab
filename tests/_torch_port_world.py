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


SCENARIOS = {"ring": ring, "sharded": sharded}
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

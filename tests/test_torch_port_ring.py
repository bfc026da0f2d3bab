"""Ring attention (K4) and its merge (K4m) against the JAX package.

The virtual ring (``ring_attention_virtual_fwd`` / ``_bwd``: n ranks in one
process, the calls per hop that each rank makes) against the JAX
``ring_attention_packed`` under ``shard_map`` on ``make_mesh(view=n)`` of
the 8 virtual CPU devices with ``impl="xla"``, at n = 1, 2, 4 and 8: the
outputs and the q, k, v gradients of a random cotangent, f32, >= 60 dB of
signal over error. ``ring_merge_plain`` against the JAX ``_merge``, >= 60
dB. A spawned ``gloo`` world of 2 processes runs the ring over point-to-
point sends (``ring_fwd`` / ``ring_bwd``), which must give the virtual
ring's results bit for bit: the same calls on the same shards in the same
order. The world starts first and runs while this process compiles the
JAX side.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from _torch_port_util import snr_db
from _torch_port_world import World
from mvd_tpu.kernels.ring_attention import _merge as j_merge
from mvd_tpu.kernels.ring_attention import ring_attention_packed as j_ring
from mvd_tpu.mesh import make_mesh as j_make_mesh
from mvd_tpu_torch.kernels import (
    attention_packed_plain,
    ring_attention_virtual_bwd,
    ring_attention_virtual_fwd,
    ring_merge,
    ring_merge_plain,
)

BAR_DB = 60.0
B, H, D, S = 2, 2, 16, 12  # S query rows and keys per rank


def _shards(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(n, B, S, H * D)).astype(np.float32) for _ in range(4)]  # q, k, v, g


def _split(x):
    return [torch.from_numpy(np.ascontiguousarray(s)) for s in x]


def _virtual(q, k, v, g):
    qs, ks, vs, gs = map(_split, (q, k, v, g))
    outs, lses = ring_attention_virtual_fwd(qs, ks, vs, H)
    grads = ring_attention_virtual_bwd(qs, ks, vs, outs, lses, gs, H)
    return outs, lses, grads


@pytest.fixture(scope="module")
def p2p(tmp_path_factory):
    """The 2-process world, started before the JAX compiles."""
    workdir = tmp_path_factory.mktemp("ring")
    q, k, v, g = _shards(2, 5)
    torch.save(dict(q=_split(q), k=_split(k), v=_split(v), do=_split(g), heads=H), workdir / "ring_in.pt")
    world = World(2, "ring", str(workdir))
    yield workdir, (q, k, v, g), world
    world.kill()


def _jax_ring(n, q, k, v, g):
    """The JAX ring on ``make_mesh(view=n)``: out and (dq, dk, dv) for the
    cotangent g; inputs and results (n, B, S, H*D), rank-major."""
    mesh = j_make_mesh(view=n)
    glob = lambda x: jnp.asarray(x.transpose(1, 0, 2, 3).reshape(B, n * S, H * D))
    spec = P(None, "view", None)
    ring = shard_map(functools.partial(j_ring, heads=H, axis_name="view", impl="xla"), mesh=mesh,
                     in_specs=(spec, spec, spec), out_specs=spec)

    @jax.jit
    def run(q, k, v, g):
        out, vjp = jax.vjp(ring, q, k, v)
        return (out, *vjp(g))

    back = lambda x: np.asarray(x).reshape(B, n, S, H * D).transpose(1, 0, 2, 3)
    return [back(x) for x in run(*map(glob, (q, k, v, g)))]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_virtual_ring_matches_jax(p2p, n):
    q, k, v, g = _shards(n, n)
    want = _jax_ring(n, q, k, v, g)
    outs, _, grads = _virtual(q, k, v, g)
    for name, w, got in zip(("out", "dq", "dk", "dv"), want, (outs, *grads)):
        assert snr_db(w, torch.stack(got).numpy()) >= BAR_DB, (n, name)


def test_single_rank_ring_is_plain_attention():
    """n = 1: one hop, K1 alone, bit for bit the plain attention."""
    q, k, v, g = _shards(1, 0)
    outs, lses, _ = _virtual(q, k, v, g)
    out, lse = attention_packed_plain(*(torch.from_numpy(x[0]) for x in (q, k, v)), H)
    assert torch.equal(outs[0], out) and torch.equal(lses[0], lse)


def test_ring_merge_plain_matches_jax():
    """K4m's plain version against the JAX ``_merge``, in place, with the
    hop's out in bf16 as K1 writes it; a CPU call is counted as plain."""
    rng = np.random.default_rng(1)
    o, o_i = (rng.normal(size=(B, S, H * D)).astype(np.float32) for _ in range(2))
    lse, lse_i = (rng.normal(3.0, 2.0, size=(B, S, H)).astype(np.float32) for _ in range(2))
    o_i16 = torch.from_numpy(o_i).bfloat16()
    want_o, want_l = j_merge(jnp.asarray(o), jnp.asarray(lse), jnp.asarray(o_i16.float().numpy()),
                             jnp.asarray(lse_i), H)
    got_o, got_l = torch.from_numpy(o.copy()), torch.from_numpy(lse.copy())
    calls = ring_merge.plain_calls
    ring_merge(got_o, got_l, o_i16, torch.from_numpy(lse_i), H)
    assert ring_merge.plain_calls == calls + 1
    assert snr_db(np.asarray(want_o), got_o.numpy()) >= BAR_DB
    assert snr_db(np.asarray(want_l), got_l.numpy()) >= BAR_DB
    again_o, again_l = torch.from_numpy(o.copy()), torch.from_numpy(lse.copy())
    ring_merge_plain(again_o, again_l, o_i16, torch.from_numpy(lse_i), H)
    assert torch.equal(again_o, got_o) and torch.equal(again_l, got_l)


def test_p2p_ring_is_the_virtual_ring(p2p):
    """The ring over a gloo process group of 2 (K/V and the dk/dv
    accumulators over batch_isend_irecv) gives each rank the virtual ring's
    out, lse, dq, dk and dv bit for bit."""
    workdir, (q, k, v, g), world = p2p
    world.wait()
    outs, lses, (dq, dk, dv) = _virtual(q, k, v, g)
    for r in range(2):
        got = torch.load(workdir / f"ring_out{r}.pt")
        for name, want in (("out", outs), ("lse", lses), ("dq", dq), ("dk", dk), ("dv", dv)):
            assert torch.equal(got[name], want[r]), (r, name)


def test_single_process_mesh_matches_jax_policy():
    """Without a process group the mesh is the one process (1 x 1 x 1):
    each block is the whole tensor. ``auto_mesh_shape`` is the JAX
    package's policy; a mesh larger than the processes raises, a model axis
    and several slices included, and a data axis that several slices do
    not divide raises as in JAX."""
    from mvd_tpu.mesh import auto_mesh_shape as j_auto_mesh_shape
    from mvd_tpu_torch.mesh import auto_mesh_shape, make_mesh, mesh_from_shape, shard_batch

    for n, views in [(1, 1), (8, 1), (8, 2), (8, 4), (8, 8), (6, 4), (4, 3), (4, 8)]:
        assert auto_mesh_shape(n, views) == j_auto_mesh_shape(n, views), (n, views)
    mesh = mesh_from_shape({"data": 1, "view": 1})
    x = torch.arange(24.0).reshape(2, 3, 4)
    assert mesh.coords == {"data": 0, "view": 0, "model": 0} and mesh.group_size == 1
    assert torch.equal(mesh.block(x), x) and torch.equal(shard_batch(mesh, {"x": x})["x"], x)
    assert torch.equal(mesh.gather_blocks(x), x)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(model=2)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(data=2, num_slices=2)
    with pytest.raises(ValueError, match="divisible by num_slices"):
        make_mesh(data=3, num_slices=2)
    with pytest.raises(ValueError, match="needs 2 processes"):
        make_mesh(view=2)


def test_initialize_resolves_rank_and_world(monkeypatch):
    """``distributed.initialize``: nothing to join without a launcher's
    variables (a no-op, as in JAX); else explicit arguments, then the
    ``MVD_*`` variables, then torchrun's, then SLURM's. Here a gloo group of
    one on the CPU, where ``MVD_NUM_PROCESSES`` beats torchrun's
    ``WORLD_SIZE``; a group of two without a coordinator raises."""
    import socket

    import torch.distributed as dist

    from mvd_tpu_torch import distributed

    for var in ("MVD_COORDINATOR", "MVD_NUM_PROCESSES", "MVD_PROCESS_ID", "MVD_LOCAL_RANK", "RANK",
                "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
                "SLURM_PROCID", "SLURM_LOCALID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize(backend="gloo", device="cpu") is False and not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        distributed.initialize(num_processes=2, process_id=0, backend="gloo", device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("WORLD_SIZE", "2")  # torchrun's, beaten by MVD_*
    monkeypatch.setenv("MVD_NUM_PROCESSES", "1")
    monkeypatch.setenv("SLURM_PROCID", "0")
    try:
        assert distributed.initialize(backend="gloo", device="cpu")
        assert (distributed.process_count(), distributed.process_index(), distributed.is_primary()) == (1, 0, True)
        assert distributed.broadcast_str("run/2026") == "run/2026"
    finally:
        distributed.shutdown()
    assert not dist.is_initialized()

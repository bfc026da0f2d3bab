"""Multi-slice meshes of the port (``mvd_tpu_torch/mesh.py:make_mesh(num_slices=k)``),
the mirror of ``tests/test_mesh_multislice.py``.

On GPUs a slice is a node: the ranks are grouped into slices by host, or
split contiguously where every rank reports one host (as JAX splits a
device list without ``slice_index``), and the slice is the outermost
factor of the data axis. One spawned ``gloo`` world of 4 CPU processes
(``_torch_port_world.py``) runs every check: the rank tables grouped by a
``hosts`` list of two interleaved hosts and by the gathered hosts (one
host here), what must raise, the view-sharded denoise on 2-slice meshes of
data 2 x view 2 against the unsharded denoise (>= 60 dB), and
``cli.train --num-slices 2 --tiny --device cpu`` for one step. The port's
view-sharded denoise is held to the JAX package's in
``test_torch_port_sharded.py``; here it is held to the port's unsharded
one, as the JAX test holds its own.
"""

import numpy as np
import pytest
import torch

from _torch_port_util import snr_db
from _torch_port_world import World

BAR_DB = 60.0


@pytest.fixture(scope="module")
def outs(tmp_path_factory):
    from tests.test_data import make_zip

    workdir = tmp_path_factory.mktemp("multislice")
    corpus = workdir / "corpus" / "renders_final"
    corpus.mkdir(parents=True)
    rng = np.random.default_rng(3)
    for i in range(6):  # under 10 objects: no validation split
        make_zip(corpus / f"obj_{i}.zip", num_views=3, size=64, rng=rng)
    World(4, "multislice", str(workdir)).wait()
    return [torch.load(workdir / f"multislice_out{r}.pt", weights_only=False) for r in range(4)]


def test_multislice_grouping(outs):
    """The slice is the outermost data factor: data rows 0 and 1 hold the
    first slice's ranks. With hosts h0, h1, h0, h1 the first slice is ranks
    0 and 2; on one host the slices are contiguous."""
    for out in outs:
        assert out["tables"]["two hosts"].tolist() == [[[0], [2]], [[1], [3]]]
        assert out["tables"]["one host"].tolist() == [[[0], [1]], [[2], [3]]]


def test_model_lines_stay_inside_a_slice(outs):
    """Data 2 x model 2 on two interleaved hosts: each model line holds one
    host's two ranks."""
    assert [out["model_line"] for out in outs] == [[0, 2], [1, 3], [0, 2], [1, 3]]


def test_multislice_requires_divisibility(outs):
    assert all(o["divisible"] == "ValueError: data axis (3) must be divisible by num_slices (2)"
               for o in outs)


def test_multislice_refuses_hosts_that_cannot_give_the_slices(outs):
    assert all(o["too_few"] == "ValueError: need 2 slices x 2 devices, have [3, 1]" for o in outs)


def test_mesh_from_shape_accepts_num_slices(outs):
    assert all(o["from_shape"] == {"data": 4, "view": 1, "model": 1} for o in outs)


@pytest.mark.parametrize("hosts", ["two hosts", "one host"])
def test_view_sharded_denoise_on_multislice_mesh(outs, hosts):
    """The ring over the view pairs of a 2-slice data axis, each rank's
    block gathered through the mesh's rank table: the unsharded denoise, on
    every rank."""
    want = outs[0]["unsharded"].numpy()
    got = outs[0]["sharded"][hosts]
    assert snr_db(want, got.numpy()) >= BAR_DB
    assert all(torch.equal(o["sharded"][hosts], got) for o in outs)


def test_view_and_model_axes_refuse_one_generation(outs):
    assert all("view axis and a model axis" in o["view_x_model"] for o in outs)


def test_train_cli_takes_num_slices(outs):
    """``cli.train --num-slices 2`` on 4 processes: a data axis of 4 over 2
    slices (contiguous on one host), one step."""
    for out in outs:
        assert out["train"]["step"] == 1
        assert out["train"]["mesh"] == {"data": 4, "view": 1, "model": 1}
        assert out["train"]["table"].flatten().tolist() == [0, 1, 2, 3]

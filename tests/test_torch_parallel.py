"""Device meshes and the lane split, port against reference: the port's
`data_mesh`/`slice_meshes` (fabric_mod_tpu_torch/parallel/mesh.py)
accept and refuse the same inputs as the reference's over its virtual
8-device CPU mesh (the port's CUDA device count patched to 8 for the
bookkeeping; nothing runs on those devices), `_bucket` pads into the
same mesh-divisible buckets, and `GpuVerifier(mesh=("cpu", "cpu"))`,
which splits each bucket into two lane ranges verified one after the
other on the CPU, gives the unsplit verifier's and the construction's
verdicts — on 64 items with planted adversarial lanes and raw-message
lanes, and on a ragged batch of 3 — with its fused lane's tensor on
mesh[0]."""
import numpy as np
import pytest
import torch

from fabric_mod_tpu_torch.bccsp import gpu
from fabric_mod_tpu_torch.parallel import data_mesh, lane_ranges, slice_meshes
from fabric_mod_tpu_torch.utils import fixtures

MESH = ("cpu", "cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the CPU verify is thousands of small ops."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def eight_cards(monkeypatch):
    """The port's view of 8 CUDA devices, for the mesh bookkeeping."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)


# each case: the call on (mesh function, args, kwargs), with devices given
# as indices into the device list
CASES = [
    ("data_mesh", (8,), {}),
    ("data_mesh", (99,), {}),
    ("data_mesh", (), {}),
    ("data_mesh", (), {"devices": [2, 3, 4, 5]}),
    ("data_mesh", (), {"n_devices": 2, "devices": [0, 1]}),
    ("data_mesh", (), {"devices": []}),
    ("data_mesh", (), {"devices": [0, 0]}),
    ("slice_meshes", (4,), {}),
    ("slice_meshes", (3,), {}),
    ("slice_meshes", (0,), {}),
    ("slice_meshes", (16,), {}),
    ("slice_meshes", (2,), {"n_devices": 4}),
    ("slice_meshes", (2,), {"n_devices": 12}),
    ("slice_meshes", (8,), {}),
]


def _outcome(fn, args, kwargs, devs, indices):
    """('raises',) or the meshes as lists of device indices."""
    kw = dict(kwargs)
    if "devices" in kw:
        kw["devices"] = [devs[i] for i in kw["devices"]]
    try:
        got = fn(*args, **kw)
    except ValueError:
        return ("raises",)
    meshes = got if isinstance(got, list) else [got]
    return [indices(mesh) for mesh in meshes]


@pytest.mark.parametrize("name, args, kwargs", CASES)
def test_meshes_accept_and_refuse_as_the_reference(eight_cards, name, args,
                                                   kwargs):
    import jax
    from fabric_mod_tpu import parallel as ref
    from fabric_mod_tpu_torch import parallel as port
    jdevs = jax.devices()
    assert len(jdevs) == 8, "conftest should provide 8 CPU devices"
    want = _outcome(getattr(ref, name), args, kwargs, jdevs,
                    lambda mesh: [jdevs.index(d) for d in mesh.devices.flat])
    cuda = [torch.device("cuda", i) for i in range(8)]
    got = _outcome(getattr(port, name), args, kwargs, cuda,
                   lambda mesh: [d.index for d in mesh])
    assert got == want


def test_slice_meshes_are_disjoint_ordered_and_complete(eight_cards):
    meshes = slice_meshes(4)
    assert [[d.index for d in m] for m in meshes] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(isinstance(m, tuple) for m in meshes)


def test_mesh_device_checks(eight_cards):
    with pytest.raises(ValueError):
        data_mesh(devices=["cuda:8"])            # beyond the count
    with pytest.raises(ValueError):
        data_mesh(devices=["cpu", "cuda:0"])     # one device type
    assert data_mesh(devices=MESH) == (torch.device("cpu"),) * 2
    assert lane_ranges(8, 2) == [(0, 4), (4, 8)]
    with pytest.raises(ValueError):
        lane_ranges(8, 3)


def test_no_card_means_no_cuda_mesh():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    with pytest.raises(RuntimeError):
        data_mesh(devices=["cuda:0"])
    with pytest.raises(ValueError):
        data_mesh()                              # zero devices: empty
    with pytest.raises(RuntimeError):
        gpu.GpuVerifier(mesh=["cuda:0"])


@pytest.mark.parametrize("n, min_div", [(1, 1), (3, 8), (5, 2), (8, 8),
                                        (9, 8), (64, 16), (65, 4),
                                        (2048, 2048), (2049, 1), (5, 4096),
                                        (3, 3)])
def test_bucket_pads_into_a_mesh_divisible_bucket(n, min_div):
    """As the reference: _bucket(3, 8) == 8, _bucket(5, 2) == 8."""
    from fabric_mod_tpu.bccsp.tpu import _bucket as ref_bucket
    try:
        want = ref_bucket(n, min_div)
    except ValueError:
        with pytest.raises(ValueError):
            gpu._bucket(n, min_div)
        return
    assert gpu._bucket(n, min_div) == want


def test_mesh_verifier_arguments():
    with pytest.raises(ValueError):
        gpu.GpuVerifier(device="cpu", mesh=MESH)
    with pytest.raises(ValueError):
        gpu.GpuVerifier(mesh=("cpu",) * 3)       # 3 does not divide 2048
    with pytest.raises(ValueError):
        gpu.GpuVerifier(mesh=())
    v = gpu.GpuVerifier(mesh=MESH, buckets=(8, 64))
    assert v.mesh == (torch.device("cpu"),) * 2 and v.device == v.mesh[0]


def _planted_64():
    items, expect = fixtures.make_block(0, n_tx=22, raw_endorsers=True)
    return items[:64], expect[:64]


@pytest.fixture(scope="module")
def cases():
    """(items, construction) for 64 planted lanes (raw endorser
    messages among them) and a ragged batch of 3."""
    planted = _planted_64()
    assert not planted[1].all()
    assert any(it.message is not None for it in planted[0])
    items, expect = fixtures.make_verify_items(3, invalid_every=3)
    return {"planted64": planted, "ragged3": (items, np.array(expect))}


@pytest.mark.parametrize("case", ["planted64", "ragged3"])
def test_mesh_verifier_equals_unsplit_and_construction(cases, case):
    items, expect = cases[case]
    calls = []
    real = gpu.GpuVerifier._verify_lanes

    def counting(self, dev, d, *rest):
        calls.append((str(dev), len(d)))
        return real(self, dev, d, *rest)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(gpu.GpuVerifier, "_verify_lanes", counting)
        split = gpu.GpuVerifier(mesh=MESH, cache_size=0).verify_many(items)
    size = gpu._bucket(len(items), 2)
    assert calls == [("cpu", size // 2), ("cpu", size // 2)]
    whole = gpu.GpuVerifier(device="cpu", cache_size=0).verify_many(items)
    assert split.tolist() == whole.tolist() == expect.tolist()


def test_mesh_fused_lane_keeps_the_verdicts_on_the_first_device(cases):
    items, expect = cases["ragged3"]
    v = gpu.GpuVerifier(mesh=MESH, cache_size=0)
    out = v.verify_many_fused_async(items + items[:1])()
    assert isinstance(out, torch.Tensor) and out.device == v.mesh[0]
    assert out.tolist() == expect.tolist() + expect.tolist()[:1]

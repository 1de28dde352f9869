"""The embedding gather's vector design, held on the CPU through its work
split composed in plain PyTorch.

On the card `gather_rows` takes the "vector" design of
csrc/embedding_gather.cu for a table row of a multiple of 16 bytes (every
d that is a multiple of 8 in bf16 or of 4 in f32): the output as n x W
words of 16 bytes, a warp an item (a tile of 32 rows, its ids read once
and shuffled to the lanes, and 8 steps of 32 consecutive words, all of a
lane's loads before its first store), on a grid of at most 16 blocks an
SM whose warps walk the items with a stride of the grid.  Other rows take
the earlier "warp_row" design.  chip_smoke.py holds the kernel against
the plain twin, against itself and against "warp_row" forced on the
card.  Here `_gather_design_plain`, the design's mapping in plain PyTorch
(which also raises unless every word is written exactly once), is held
against `gather_plain` with the rows of ids outside [0, V) zero, and
against JAX's `gather` (the Pallas `_gather_kernel` in interpret mode,
as tests/test_torch_gather.py runs it) on in-range ids: n = 1, 31, 32,
33, 257, 4,099, d = 16, 64, 128, 256, f32 and bf16, on 132 SMs and on
one (where each warp walks several items).  The routes, the grid rule
and the refused designs are held without any build.

Tolerance: none.  A gather copies bits, so every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtamrecommender_tpu.ops.pallas import embedding_kernel as jek
from mtamrecommender_tpu_torch.ops.kernels import build
from mtamrecommender_tpu_torch.ops.kernels import embedding_kernel as tek

torch.set_num_threads(2)

V = 300
NS = (1, 31, 32, 33, 257, 4099)
DS = (16, 64, 128, 256)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _table(seed, d):
    r = np.random.RandomState(seed)
    return r.randn(V, d).astype(np.float32)


def _ids(seed, n, invalid):
    """n ids in [0, V); with ``invalid``, every 5th (from the 3rd) below 0
    and every 7th (from the 5th) at or past V."""
    r = np.random.RandomState(seed)
    ids = r.randint(0, V, n).astype(np.int32)
    if invalid:
        ids[2::5] = -1 - ids[2::5]
        ids[4::7] = V + ids[4::7]
    return ids


def _masked_plain(table, ids):
    """gather_plain with a zero row for each id outside [0, V)."""
    want = tek.gather_plain(table, ids.clamp(0, V - 1))
    want[(ids < 0) | (ids >= V)] = 0
    return want


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the check reached the CUDA build")
    monkeypatch.setattr(build, "library", refuse)


# ------------------------------------------------------------ the design

@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_design_plain_matches_the_masked_twin(n, d, dname, sms):
    table = torch.tensor(_table(n + d, d)).to(DTYPES[dname][0])
    ids = torch.tensor(_ids(n * d, n, invalid=True))
    got = tek._gather_design_plain(table, ids, sms)
    assert got.dtype == table.dtype and got.shape == (n, d)
    want = _masked_plain(table, ids)
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())
    assert torch.equal(got, want)


@pytest.mark.parametrize("dname", list(DTYPES))
@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("n", NS)
def test_design_plain_matches_jax(n, d, dname):
    tdt, jdt = DTYPES[dname]
    table = _table(n + d, d)
    ids = _ids(n * d + 1, n, invalid=False)
    want = np.asarray(jek.gather(jnp.asarray(table, jdt), jnp.asarray(ids)),
                      np.float32)
    got = tek._gather_design_plain(torch.tensor(table).to(tdt),
                                   torch.tensor(ids))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_design_plain_refuses_other_rows():
    with pytest.raises(ValueError, match="does not take"):
        tek._gather_design_plain(torch.zeros(4, 6, dtype=torch.bfloat16),
                                 torch.zeros(2, dtype=torch.int32))


# ------------------------------------------------------------ routing

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 48, 64, 96, 128, 192, 256, 8, 24])
def test_vector_takes_every_row_of_a_multiple_of_16_bytes(no_build, dtype,
                                                          d):
    row_bytes = d * torch.tensor([], dtype=dtype).element_size()
    assert tek.gather_design(row_bytes) == "vector"


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 3),
                                     (torch.bfloat16, 6),
                                     (torch.bfloat16, 12),
                                     (torch.float32, 3), (torch.float32, 6),
                                     (torch.float32, 1)])
def test_warp_row_takes_the_other_rows(no_build, dtype, d):
    row_bytes = d * torch.tensor([], dtype=dtype).element_size()
    assert tek.gather_design(row_bytes) == "warp_row"


def test_designs_in_the_c_interface_order():
    assert tek.GATHER_DESIGNS == ("vector", "warp_row")


@pytest.mark.parametrize("n,row_bytes,sms,blocks", [
    (131072, 256, 132, 1024),     # L=2048, d=128 bf16: one item a warp
    (131072, 512, 132, 2048),     # f32
    (12800, 256, 132, 100),       # L=50
    (256, 256, 132, 2),
    (1, 32, 132, 1),
    (0, 256, 132, 0),
    (1 << 20, 256, 132, 2112),    # past 16 blocks an SM: warps walk items
    (4099, 1024, 1, 16)])
def test_grid_rule(no_build, n, row_bytes, sms, blocks):
    assert tek.gather_grid(n, row_bytes, sms) == blocks


# ------------------------------------------------------- refused designs

@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_unknown_design_refused_before_any_build(no_build, device):
    table = torch.zeros(4, 16, device=device)
    ids = torch.zeros(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="unknown design"):
        tek.gather_rows(table, ids, _design="rows")


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 3),
                                     (torch.bfloat16, 6),
                                     (torch.float32, 6)])
def test_forced_vector_outside_its_rows_refused_before_any_build(
        no_build, device, dtype, d):
    table = torch.zeros(4, d, dtype=dtype, device=device)
    ids = torch.zeros(2, dtype=torch.int32, device=device)
    with pytest.raises(ValueError, match="does not take"):
        tek.gather_rows(table, ids, _design="vector")


@pytest.mark.parametrize("design", [None, "vector", "warp_row"])
def test_cpu_tensors_take_the_twin(no_build, design):
    table = torch.randn(V, 16)
    ids = torch.tensor(_ids(3, 40, invalid=False))
    assert torch.equal(tek.gather_rows(table, ids, _design=design),
                       tek.gather_plain(table, ids))


class _FakeLib:
    """Stands in for the built library: records each gather launch's
    design and reports success."""

    def __init__(self):
        self.designs = []

    def gather_launch(self, *args):
        self.designs.append(args[6])
        return 0


@pytest.mark.parametrize("dtype,d,forced,design", [
    (torch.float32, 128, None, "vector"),
    (torch.bfloat16, 128, None, "vector"),
    (torch.bfloat16, 16, None, "vector"),
    (torch.float32, 128, "warp_row", "warp_row"),
    (torch.bfloat16, 6, None, "warp_row"),
    (torch.float32, 6, "warp_row", "warp_row")])
def test_launch_takes_the_design_it_should(monkeypatch, dtype, d, forced,
                                           design):
    """The launch passes the library the design picked (or forced), the
    library looked up once and kept; `gather_launches` counts every launch
    under "gather" and the warp_row design's also under
    "gather_warp_row"."""
    lib = _FakeLib()
    looked_up = []
    monkeypatch.setattr(tek, "_gather_entry", None)
    monkeypatch.setattr(tek, "_gather_library",
                        lambda: looked_up.append(1) or lib)
    monkeypatch.setattr(build, "launch_context", lambda *_a: (0, 0))
    table = torch.empty(V, d, dtype=dtype, device="meta")
    ids = torch.empty(50, dtype=torch.int32, device="meta")
    before = dict(tek.gather_launches)
    for _ in range(2):
        out = tek._launch_gather(table, ids,
                                 tek._gather_pick(table, forced))
    assert lib.designs == [tek.GATHER_DESIGNS.index(design)] * 2
    assert looked_up == [1]
    assert out.shape == (50, d) and out.dtype == dtype
    assert tek.gather_launches["gather"] == before["gather"] + 2
    assert tek.gather_launches["gather_warp_row"] == (
        before["gather_warp_row"] + 2 * int(design == "warp_row"))
    assert tek.gather_launches["scatter_add"] == before["scatter_add"]

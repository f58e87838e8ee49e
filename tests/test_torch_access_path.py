"""The rule in Python that picks how K1, K2 and K3 read their tables on
the card (``access_path``, K1's ``lookup_access_path`` over its two
tables: 4 columns per access, or one).  It reads only shapes and
pointers, so it is checked here on CPU tensors; the card tests run both
paths.  The tile plan is the kernels' own (``csrc/tile_accum.cuh``) and
is exercised by the card tests."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.cache_lookup import lookup_access_path  # noqa: E402
from repro_torch.kernels.gather_agg import access_path  # noqa: E402
from repro_torch.sampling import kernels as k3  # noqa: E402


def view_at(offset: int, shape: tuple, dtype) -> torch.Tensor:
    """A contiguous view ``offset`` elements into a fresh buffer."""
    flat = torch.zeros(offset + shape[0] * shape[1], dtype=dtype)
    return flat[offset:].view(shape)


# (D, offset in elements, path): the main path's widths, widths that are
# not a multiple of 4, and views whose first row is not aligned (a 4-element
# offset keeps 16-byte f32 / 8-byte bf16 alignment)
CASES = [(64, 0, "vector"), (100, 0, "vector"), (256, 0, "vector"),
         (520, 0, "vector"), (30, 0, "scalar"), (33, 0, "scalar"),
         (1, 0, "scalar"), (2, 0, "scalar"), (3, 0, "scalar"),
         (5, 0, "scalar"), (64, 1, "scalar"), (64, 2, "scalar"),
         (64, 3, "scalar"), (64, 4, "vector"), (100, 8, "vector")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset,path", CASES)
def test_access_path_needs_d_multiple_of_4_and_aligned_rows(
        dtype, d, offset, path):
    table = view_at(offset, (10, d), dtype)
    if offset == 0:
        assert table.data_ptr() % 64 == 0     # a fresh buffer is aligned
    assert access_path(table) == path


def test_k3_takes_the_same_rule():
    assert k3.access_path is access_path


# (D, cache offset, streamed offset, path), offsets in elements of each
# table's own dtype: the vector path needs D % 4 == 0 and BOTH tables
# aligned (4 elements keep 16-byte f32 / 8-byte bf16 alignment; 1, 2 and
# 3 keep neither)
LOOKUP_CASES = [(100, 0, 0, "vector"), (64, 0, 0, "vector"),
                (30, 0, 0, "scalar"), (33, 0, 0, "scalar"),
                (64, 1, 0, "scalar"), (64, 0, 1, "scalar"),
                (64, 2, 0, "scalar"), (64, 0, 2, "scalar"),
                (64, 3, 3, "scalar"), (64, 4, 0, "vector"),
                (64, 0, 4, "vector"), (100, 8, 4, "vector"),
                (30, 4, 4, "scalar")]


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,cache_off,streamed_off,path", LOOKUP_CASES)
def test_lookup_access_path_needs_both_tables_aligned(
        cache_dtype, d, cache_off, streamed_off, path):
    cache = view_at(cache_off, (5, d), cache_dtype)
    streamed = view_at(streamed_off, (20, d), torch.float32)
    assert lookup_access_path(cache, streamed) == path
    # the rule is access_path's, table by table
    assert (path == "vector") == (access_path(cache) == "vector"
                                  == access_path(streamed))

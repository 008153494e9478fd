"""K9's plain split fold (tests/test_torch_split.py) on K3's route scene
and on k4's with every triangle drawn twice: the copy after the original,
so that equal-z winners of different parts meet at many pixels and the
smaller gid wins. (Split from that file so that each file keeps under ten
cases.)"""

import pytest

from test_torch_split import check_split_fold
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("part_entries", [1, 3, 16])
@pytest.mark.parametrize("name, tile_h", [
    ("k3", 8), ("k4 doubled", 8), ("k4 doubled", 32)])
def test_split_fold_equals_gbuffer_plain(name, tile_h, part_entries):
    """Parts of 1, 3 and 16 entries merged by the key give gbuffer_plain's
    gid and 11 planes bit for bit; on the doubled scene equal-z winners of
    different parts meet at many pixels and the smaller gid wins."""
    check_split_fold(name, tile_h, part_entries)

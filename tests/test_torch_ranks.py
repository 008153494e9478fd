"""How ``entry.run_ranks`` picks its process group and each rank's card,
on the CPU, without spawning.

NCCL with rank r on cuda:r where every rank has a card of its own; gloo
where ranks share cards (rank r on cuda:(r % cards)) or run on the CPU;
an explicit ``backend="nccl"`` that cannot run raises before any rank is
spawned, and never becomes gloo. Card counts are patched: no card is
needed. The frames over gloo CPU ranks are held in tests/test_torch_mesh.py
and tests/test_torch_entry.py; over NCCL, one rank a card, in
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pytest
import torch
import torch.multiprocessing as mp

from tpu_renderer_torch import _cuda, entry
from torch_threads import one_torch_thread  # noqa: F401

WORLD_SIZES = (1, 2, 4)


class Spawned(Exception):
    """Raised by the patched spawn: a rank would have started."""


@pytest.fixture
def spawn_calls(monkeypatch):
    """Patches ``torch.multiprocessing.spawn`` to record its arguments and
    raise ``Spawned``, and the kernel build to do nothing."""
    calls = []

    def spawn(fn, args, nprocs, **kw):
        calls.append((args, nprocs))
        raise Spawned

    monkeypatch.setattr(mp, "spawn", spawn)
    monkeypatch.setattr(_cuda, "build", lambda: None)
    return calls


def patch_cards(monkeypatch, cards):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)


@pytest.mark.parametrize("cards", [0, 1, 2, 4, 8])
def test_backend_and_card_of_each_rank(cards):
    for n in WORLD_SIZES:
        own_card = cards >= n
        assert entry.process_group_backend("cuda", n, cards) == (
            "nccl" if own_card else "gloo")
        assert entry.process_group_backend("cpu", n, cards) == "gloo"
        assert entry.process_group_backend("cuda", n, cards, "gloo") == "gloo"
        if own_card:
            assert entry.process_group_backend("cuda", n, cards,
                                               "nccl") == "nccl"
        else:
            with pytest.raises(ValueError, match="needs a card for each"):
                entry.process_group_backend("cuda", n, cards, "nccl")
        with pytest.raises(ValueError, match="on the CPU"):
            entry.process_group_backend("cpu", n, cards, "nccl")
        devices = [entry.rank_device(r, cards) for r in range(n)]
        if not cards:
            assert devices == [torch.device("cpu")] * n
        elif own_card:
            assert devices == [torch.device("cuda", r) for r in range(n)]
        else:
            assert devices == [torch.device("cuda", r % cards)
                               for r in range(n)]
            assert len(set(devices)) == cards


def test_nccl_on_the_cpu_raises_before_spawning(spawn_calls):
    with pytest.raises(ValueError, match="needs a card for each rank"):
        entry.run_ranks(entry.mesh_frames, 2, (), device="cpu",
                        backend="nccl")
    with pytest.raises(ValueError, match="on the CPU"):
        entry.dryrun_multichip(1, device="cpu", backend="nccl")
    assert spawn_calls == []


def test_nccl_with_more_ranks_than_cards_raises_before_spawning(
        monkeypatch, spawn_calls):
    patch_cards(monkeypatch, 2)
    with pytest.raises(ValueError, match="4 ranks on 2 card"):
        entry.run_ranks(entry.mesh_frames, 4, (), device="cuda",
                        backend="nccl")
    with pytest.raises(ValueError, match="3 ranks on 2 card"):
        entry.dryrun_multichip(3, backend="nccl")
    assert spawn_calls == []


def test_an_unknown_backend_raises(spawn_calls):
    for device_type in ("cuda", "cpu"):
        with pytest.raises(ValueError, match="unknown process group"):
            entry.process_group_backend(device_type, 1, 1, "mpi")
    with pytest.raises(ValueError, match="unknown process group backend"):
        entry.run_ranks(entry.mesh_frames, 1, (), device="cpu",
                        backend="mpi")
    assert spawn_calls == []


def test_run_ranks_hands_its_ranks_the_chosen_backend(monkeypatch,
                                                      spawn_calls):
    """NCCL reaches the ranks where each has a card, gloo where they share
    cards or run on the CPU, and an explicit gloo on four cards."""
    for cards, device, backend, want in ((4, "cuda", None, "nccl"),
                                         (8, "cuda", None, "nccl"),
                                         (2, "cuda", None, "gloo"),
                                         (1, "cuda", None, "gloo"),
                                         (4, "cuda", "gloo", "gloo"),
                                         (4, "cpu", None, "gloo")):
        patch_cards(monkeypatch, cards)
        with pytest.raises(Spawned):
            entry.run_ranks(entry.mesh_frames, 4, (), device=device,
                            backend=backend)
        args, nprocs = spawn_calls.pop()
        # (world size, rendezvous dir, device type, backend, body, args)
        assert nprocs == 4 and args[0] == 4
        assert args[2:5] == (device, want, entry.mesh_frames)

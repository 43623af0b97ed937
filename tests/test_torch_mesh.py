"""The port's backend and card choice for a rank (parallel/mesh.py), on
the CPU with the node's card count and the launcher's environment
patched; no process group is made.

A rank decides from its place on its node: ``LOCAL_RANK`` and
``LOCAL_WORLD_SIZE`` where the launcher sets them, else the rank and the
world size. NCCL where the node's ranks are no more than its cards, each
local rank on its own card; gloo on the CPU and where ranks share a card.
"""

import pytest
import torch

from neuralmelting_tpu_torch.parallel import mesh


@pytest.fixture
def cards(monkeypatch):
    """Pretend the node has ``n`` cards; no launcher variables set."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)

    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)

    return set_cards


@pytest.mark.parametrize("local_rank_set", [True, False],
                         ids=["LOCAL_RANK", "derived"])
def test_two_nodes_of_eight_cards_take_nccl(cards, monkeypatch,
                                            local_rank_set):
    cards(8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    if local_rank_set:
        monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.local_layout(16, 11) == (3, 8)
    assert mesh.rank_device("cuda", 16, 11) == "cuda:3"
    assert mesh.pick_backend("cuda:3", 16, 11) == "nccl"
    assert mesh.pick_backend("cuda", 16, 11) == "nccl"
    with pytest.raises(ValueError, match="local rank 3"):
        mesh.pick_backend("cuda:11", 16, 11)


def test_every_rank_of_a_uniform_launch_chooses_alike(cards, monkeypatch):
    cards(8)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    got = set()
    for rank in range(16):
        monkeypatch.setenv("LOCAL_RANK", str(rank % 8))
        dev = mesh.rank_device("cuda", 16, rank)
        assert dev == f"cuda:{rank % 8}"
        got.add(mesh.pick_backend(dev, 16, rank))
    assert got == {"nccl"}


def test_one_node_without_launcher_variables(cards):
    cards(4)
    assert mesh.local_layout(4, 2) == (2, 4)
    assert mesh.rank_device("cuda", 4, 2) == "cuda:2"
    assert mesh.pick_backend("cuda:2", 4, 2) == "nccl"


def test_two_ranks_on_one_card_take_gloo(cards):
    cards(1)
    assert mesh.pick_backend("cuda", 2, 0) == "gloo"
    assert [mesh.rank_device("cuda", 2, i) for i in range(2)] == [
        "cuda:0", "cuda:0"]
    assert mesh.pick_backend("cuda:0", 2, 1) == "gloo"


def test_a_cpu_device_takes_gloo(cards):
    cards(8)
    assert mesh.pick_backend("cpu", 2, 1) == "gloo"
    assert mesh.rank_device("cpu", 2, 1) == "cpu"

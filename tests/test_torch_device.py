"""Device resolution: the port's default is the card, and with no card it
raises instead of carrying on on the CPU. Card presence is patched inside
each test, never decided at import."""

import numpy as np
import pytest
import torch

from vector_indexer_tpu_torch import bindings
from vector_indexer_tpu_torch.device import resolve_device
from vector_indexer_tpu_torch.index.ivf import IvfIndex
from vector_indexer_tpu_torch.ops.block_stream import build_stream_table_from_rows


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", torch.device("cuda", 0)])
def test_a_cuda_device_without_a_card_raises(no_card, device):
    with pytest.raises(RuntimeError, match='device="cpu"'):
        resolve_device(device)


@pytest.mark.parametrize("device", ["cpu", torch.device("cpu")])
def test_the_cpu_only_when_asked(no_card, device):
    assert resolve_device(device) == torch.device("cpu")


def test_default_is_the_first_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda", 0)


def test_unknown_device_type_raises():
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_the_card(no_card, tmp_path):
    xb = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        IvfIndex(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        bindings.build(xb, str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        bindings.load(str(tmp_path / "index"), str(tmp_path / "shards"), 8)


def test_host_stream_table_defaults_to_the_card(no_card):
    """The stream table's build from a host layout's rows
    (``build_stream_table_from_rows``) resolves its device like every entry
    point (the layout and its rows are never touched before the device is
    known)."""
    with pytest.raises(RuntimeError, match="CUDA"):
        build_stream_table_from_rows(layout=None, centroids=None, row_chunks=None)

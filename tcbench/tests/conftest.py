"""Shared helpers of the benchmark's own tests (CPU; card tests skip here)."""
import pytest
import torch


@pytest.fixture
def card():
    """The card, or a skip where none is present (decided inside the test)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; torch.cuda.is_available() is false here")
    return torch.device("cuda")

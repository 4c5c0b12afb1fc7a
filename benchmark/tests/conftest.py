import pytest


@pytest.fixture
def cuda():
    """The card, decided when a test asks for it (never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs at its own size "
                    "on the card")
    return torch.device("cuda")

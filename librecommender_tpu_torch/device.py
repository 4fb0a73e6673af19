"""Where the port runs: the GPU unless the caller asks for the CPU."""
import torch


def resolve_device(device=None):
    """``None`` means ``"cuda"``. A CUDA device without a GPU raises: the port
    never moves to the CPU on its own; pass ``device="cpu"`` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA GPU is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev

from repro_torch.models import lenet

__all__ = ["lenet"]

from repro_torch.optim.optim import Optimizer, apply_updates, sgd

__all__ = ["Optimizer", "apply_updates", "sgd"]

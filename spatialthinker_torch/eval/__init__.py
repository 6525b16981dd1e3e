from .providers import TorchProvider

__all__ = ["TorchProvider"]

"""KL coefficient controllers (the port's own copy of
``spatialthinker_tpu/algos/kl_controller.py``; host code)."""

from __future__ import annotations

from abc import ABC, abstractmethod


class KLController(ABC):
    kl_coef: float

    @abstractmethod
    def update(self, current_kl: float, n_steps: int) -> None: ...


class FixedKLController(KLController):
    def __init__(self, init_kl_coef: float):
        self.kl_coef = init_kl_coef

    def update(self, current_kl: float, n_steps: int) -> None:
        pass


class AdaptiveKLController(KLController):
    """Adaptive controller from https://arxiv.org/pdf/1909.08593.pdf."""

    def __init__(self, init_kl_coef: float, target_kl: float, horizon: float):
        self.kl_coef = init_kl_coef
        self.target = target_kl
        self.horizon = horizon

    def update(self, current_kl: float, n_steps: int) -> None:
        proportional_error = min(max(current_kl / self.target - 1.0, -0.2), 0.2)
        mult = 1 + proportional_error * n_steps / self.horizon
        self.kl_coef *= mult


def get_kl_controller(kl_type: str, kl_coef: float, kl_target: float = 0.0, kl_horizon: float = 0.0) -> KLController:
    if kl_type == "fixed":
        return FixedKLController(init_kl_coef=kl_coef)
    if kl_type == "adaptive":
        if kl_horizon <= 0:
            raise ValueError(f"horizon must be larger than 0. Got {kl_horizon}.")
        return AdaptiveKLController(init_kl_coef=kl_coef, target_kl=kl_target, horizon=kl_horizon)
    raise ValueError(f"Unknown kl type: {kl_type}.")

from .advantages import (
    compute_gae_advantage_return,
    compute_grpo_outcome_advantage,
    compute_reinforce_plus_plus_outcome_advantage,
    compute_remax_outcome_advantage,
    compute_rloo_outcome_advantage,
)
from .kl_controller import AdaptiveKLController, FixedKLController, get_kl_controller
from .losses import (
    compute_kl,
    compute_policy_loss,
    compute_rewards,
    compute_value_loss,
    entropy_from_logits,
)
from .masked import masked_mean, masked_var, masked_whiten

__all__ = [
    "compute_gae_advantage_return",
    "compute_grpo_outcome_advantage",
    "compute_reinforce_plus_plus_outcome_advantage",
    "compute_remax_outcome_advantage",
    "compute_rloo_outcome_advantage",
    "AdaptiveKLController",
    "FixedKLController",
    "get_kl_controller",
    "compute_kl",
    "compute_policy_loss",
    "compute_rewards",
    "compute_value_loss",
    "entropy_from_logits",
    "masked_mean",
    "masked_var",
    "masked_whiten",
]

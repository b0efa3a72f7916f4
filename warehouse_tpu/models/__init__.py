"""Actor-critic policy models (plain JAX)."""

from .policy import (ActorCriticAttn, ActorCriticCNN, ActorCriticMLP,
                     ActorCriticRNN, MultiPolicyActorCritic, make_model,
                     make_multi_policy_model)

__all__ = ["ActorCriticMLP", "ActorCriticCNN", "ActorCriticAttn",
           "ActorCriticRNN", "MultiPolicyActorCritic", "make_model",
           "make_multi_policy_model"]

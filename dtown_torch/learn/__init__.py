"""The PPO, recurrent-PPO and imitation learners on the port
(counterpart of dtown/learn)."""
from dtown_torch.learn.networks import ActorCritic  # noqa: F401
from dtown_torch.learn.ppo import PPOConfig, TrainState, make_ppo  # noqa: F401

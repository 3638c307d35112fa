"""RLHF: PPO losses, GAE, the packed train steps, the reward model and the
experiment's executors."""

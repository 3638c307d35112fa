"""RLHF: PPO losses, GAE, the packed and padded train steps, the reward
model and the experiment's executors; the paper's other algorithms (§8.3):
DPO, GRPO and ReMax train steps."""

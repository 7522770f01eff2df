"""The PPO update's (learn/ppo.py ``update``) ms an iteration: CUDA events
around it in each traced iteration, averaged."""


def read(record):
    return record.get("update_ms")

"""The NatureCNN policy's FLOPs from the configuration's shapes: 2 x the
multiply-adds of each convolution (output pixels x k x k x C_in x C_out,
SAME padding) and dense layer (in x out); biases, activations and the
heads' elementwise work left out."""

# (features, kernel, stride) of the three convolutions, then Dense(512)
NATURE = ((32, 8, 4), (64, 4, 2), (64, 3, 1))
NATURE_DENSE = 512


def nature_forward_flops(H, W, C, action_dim=2):
    """Forward FLOPs of one observation [H, W, C] through the NatureCNN
    trunk and the mean and value heads."""
    flops = 0
    for f, k, s in NATURE:
        H, W = -(-H // s), -(-W // s)
        flops += 2 * H * W * k * k * C * f
        C = f
    flops += 2 * H * W * C * NATURE_DENSE
    return flops + 2 * NATURE_DENSE * (action_dim + 1)


def ppo_iteration_flops(f_fwd, ppo, num_envs):
    """One PPO iteration: the rollout's forward on T x B observations and
    the last one's B, and the update's forward and backward (3 x forward)
    on every transition in each epoch."""
    T = ppo["rollout_len"]
    return f_fwd * (T * num_envs + num_envs) + \
        3 * f_fwd * ppo["epochs"] * T * num_envs

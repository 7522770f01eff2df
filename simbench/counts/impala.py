"""The IMPALA-CNN policy's FLOPs from the configuration's shapes, counted
as counts/policy.py counts NatureCNN: 2 x the multiply-adds of each
convolution (output pixels x 3 x 3 x C_in x C_out, SAME padding) and
dense layer (in x out); biases, pools, residual adds, activations and the
heads' elementwise work left out. One iteration's count is
policy.ppo_iteration_flops of this forward count."""

# channels of the three stages; each stage is a 3x3 convolution, a 3x3
# stride-2 max pool and two residual blocks of two 3x3 convolutions
IMPALA = (16, 32, 32)
IMPALA_DENSE = 256


def impala_forward_flops(H, W, C, action_dim=2):
    """Forward FLOPs of one observation [H, W, C] through the IMPALA-CNN
    trunk and the mean and value heads."""
    flops = 0
    for f in IMPALA:
        flops += 2 * H * W * 9 * C * f          # the stage's convolution
        H, W, C = -(-H // 2), -(-W // 2), f     # the pool
        flops += 4 * 2 * H * W * 9 * C * C      # two blocks of two
    flops += 2 * H * W * C * IMPALA_DENSE
    return flops + 2 * IMPALA_DENSE * (action_dim + 1)

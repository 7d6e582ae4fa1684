from .pnp import (CSMRIState, PnPEnv, admm_step, compute_reward,
                  fixed_param_rollout, get_policy_ob, reset_from_mat)

__all__ = ["CSMRIState", "PnPEnv", "admm_step", "compute_reward",
           "fixed_param_rollout", "get_policy_ob", "reset_from_mat"]

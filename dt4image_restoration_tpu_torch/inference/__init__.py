from .evaluator import (EvalBuffers, Evaluator, greedy_rollout,
                        initial_policy_setup, make_policy_step)

__all__ = ["EvalBuffers", "Evaluator", "greedy_rollout",
           "initial_policy_setup", "make_policy_step"]

from .evaluator import (EvalBuffers, Evaluator, PolicyGraphs,
                        check_policy_forward, greedy_rollout,
                        initial_policy_setup, make_policy_step,
                        policy_forward, seed_buffers)
from .mcts import (MCTS, BatchedMCTS, Node, fold_and_sort, run_mcts,
                   sample_actions, select_p_ucb)
from .mcts_device import DeviceMCTS, max_backprop

__all__ = ["BatchedMCTS", "DeviceMCTS", "EvalBuffers", "Evaluator", "MCTS",
           "Node", "PolicyGraphs", "check_policy_forward", "fold_and_sort",
           "greedy_rollout", "initial_policy_setup", "make_policy_step",
           "max_backprop", "policy_forward", "run_mcts", "sample_actions",
           "seed_buffers", "select_p_ucb"]

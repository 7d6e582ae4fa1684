from .evaluator import (EvalBuffers, Evaluator, greedy_rollout,
                        initial_policy_setup, make_policy_step, seed_buffers)
from .mcts import (MCTS, BatchedMCTS, Node, fold_and_sort, run_mcts,
                   sample_actions, select_p_ucb)

__all__ = ["BatchedMCTS", "EvalBuffers", "Evaluator", "MCTS", "Node",
           "fold_and_sort", "greedy_rollout",
           "initial_policy_setup", "make_policy_step", "run_mcts",
           "sample_actions", "seed_buffers", "select_p_ucb"]

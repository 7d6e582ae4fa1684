from .datasets import (EvaluationDataset, EvaluationFlexibleDataset,
                       EvaluationOptimalDataset, extract_task,
                       minmax_normalize)
from .synthetic import make_mat_record, radial_mask, shepp_logan, \
    write_eval_dir

__all__ = ["EvaluationDataset", "EvaluationFlexibleDataset",
           "EvaluationOptimalDataset", "extract_task", "make_mat_record",
           "minmax_normalize", "radial_mask", "shepp_logan",
           "write_eval_dir"]

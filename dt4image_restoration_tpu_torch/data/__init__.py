from .datasets import (BATCH_KEYS, EvaluationDataset,
                       EvaluationFlexibleDataset, EvaluationOptimalDataset,
                       TrainingDataset, extract_task, minmax_normalize)
from .native_loader import gather_scale_u8
from .synthetic import cartesian_mask, make_mat_record, radial_mask, \
    shepp_logan, write_eval_dir

__all__ = ["BATCH_KEYS", "EvaluationDataset", "EvaluationFlexibleDataset",
           "EvaluationOptimalDataset", "TrainingDataset", "cartesian_mask",
           "extract_task", "gather_scale_u8", "make_mat_record",
           "minmax_normalize", "radial_mask", "shepp_logan",
           "write_eval_dir"]

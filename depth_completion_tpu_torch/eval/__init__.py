from depth_completion_tpu_torch.eval.analyzer import analyze_datasets
from depth_completion_tpu_torch.eval.metrics import calc_bins, np_mae, np_rmse

__all__ = ["analyze_datasets", "calc_bins", "np_mae", "np_rmse"]

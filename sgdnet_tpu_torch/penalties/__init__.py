from sgdnet_tpu_torch.penalties.penalties import ElasticNet, GroupLasso, Penalty, Ridge, select_penalty

__all__ = ["Penalty", "Ridge", "ElasticNet", "GroupLasso", "select_penalty"]

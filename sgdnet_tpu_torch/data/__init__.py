from sgdnet_tpu_torch.data.datasets import load_abalone, load_dataset, load_heart, load_student, load_wine

__all__ = ["load_dataset", "load_abalone", "load_heart", "load_wine", "load_student"]

from repro_torch.optim.optimizers import Optimizer, adam, sgd
from repro_torch.optim.schedules import constant, paper_decay

__all__ = ["Optimizer", "adam", "sgd", "constant", "paper_decay"]

"""Training of the port: the optimizer of the reference recipe
(``make_optimizer``) and the pre-training step (``TrainStep``)."""

from .optim import AdamW, cosine_annealing_schedule, make_optimizer
from .step import TrainStep

__all__ = ['AdamW', 'TrainStep', 'cosine_annealing_schedule',
           'make_optimizer']

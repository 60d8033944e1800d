"""Training of the port: the optimizer of the reference recipe
(``make_optimizer``, whose defaults are also the fine-tune's: lr 2e-4,
weight decay 0.01, backbone lr x 0.1, clip 35), InternImage's layer-wise
decay (``make_layer_decay_optimizer``), the pre-training step
(``TrainStep``), the detection fine-tune step (``DetTrainStep``) and
UniAD's end-to-end step (``UniADTrainStep``); the video-replay step
(``make_video_train_step``, ``train/video_runner.py``) and
``label_smoothing_loss`` (``train/losses.py``) are imported from their
modules."""

from .optim import (AdamW, cosine_annealing_schedule, layer_decay_lr_mult,
                    make_layer_decay_optimizer, make_optimizer)
from .step import DetTrainStep, TrainStep, UniADTrainStep

__all__ = ['AdamW', 'DetTrainStep', 'TrainStep', 'UniADTrainStep',
           'cosine_annealing_schedule', 'layer_decay_lr_mult',
           'make_layer_decay_optimizer', 'make_optimizer']

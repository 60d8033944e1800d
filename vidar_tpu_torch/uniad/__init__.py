"""UniAD, the end-to-end driving stack (port of vidar_tpu/uniad/): the
fixed-capacity tracker (``track.py``), the clip matcher
(``clip_matcher.py``), the task heads (``motion_head.py``, ``occ_head.py``,
``panseg_head.py``, ``planning_head.py``), the dispatcher (``uniad.py``),
the weighted loss (``loss.py``), the eval metrics (``metrics.py``) and the
host-side trajectory smoother (``motion_optimization.py``), on the shared
BEV encoder."""

from .heads import (MotionHead, OccHead, PansegformerHead,
                    PlanningHeadSingleMode)
from .loss import UniADTargets, uniad_clip_loss, uniad_loss
from .metrics import (IntersectionOverUnion, MotionMetric, PanopticMetric,
                      PlanningMetric)
from .motion_optimization import MotionNonlinearSmoother, nonlinear_smoother
from .track import QueryInteractionModule, RuntimeTracker, TrackInstances
from .uniad import UniAD, UniADTrack

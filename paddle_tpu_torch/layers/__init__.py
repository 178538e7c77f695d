"""Layer builders (the counterpart of ``paddle_tpu/layers``)."""

from . import learning_rate_scheduler, math_op_patch, ops  # noqa: F401
from .io import *  # noqa: F401,F403
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403

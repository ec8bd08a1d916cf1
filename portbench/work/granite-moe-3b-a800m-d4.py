"""granite-moe-3b-a800m at 4 of its 32 layers: a decoder whose every FFN
is 40 experts, 8 active a token."""
from portbench.work.common import moe_decoder as step_work  # noqa: F401

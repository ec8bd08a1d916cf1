"""whisper-medium whole: 24 encoder layers over the frames, 24 decoder
layers over the tokens."""
from portbench.work.common import encdec as step_work  # noqa: F401

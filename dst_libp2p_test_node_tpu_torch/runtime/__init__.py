from .simulator import ExperimentConfig, MessageRecord, Simulator  # noqa: F401
from .summarize import LatencySummary, report, summarize  # noqa: F401

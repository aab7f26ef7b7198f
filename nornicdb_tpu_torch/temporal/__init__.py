"""Temporal access tracking: the port's copy of ``nornicdb_tpu/temporal``
(ref: the upstream NornicDB pkg/temporal/). Host code: no device work."""

from nornicdb_tpu_torch.temporal.decay_integration import (
    DecayComponent,
    DecayIntegration,
    DecayIntegrationConfig,
    DecayModifier,
    aggressive_decay_config,
    conservative_decay_config,
)
from nornicdb_tpu_torch.temporal.evolution import (
    RelationshipConfig,
    RelationshipEvolution,
    RelationshipTrend,
)
from nornicdb_tpu_torch.temporal.patterns import (
    PATTERN_BURST,
    PATTERN_DAILY,
    PATTERN_DECAYING,
    PATTERN_GROWING,
    PATTERN_WEEKLY,
    DetectedPattern,
    PatternDetector,
    PatternDetectorConfig,
)
from nornicdb_tpu_torch.temporal.tracker import (
    AccessRecord,
    SessionDetector,
    TemporalTracker,
    TrackerConfig,
)

__all__ = [
    "AccessRecord", "SessionDetector", "TemporalTracker", "TrackerConfig",
    "PatternDetector", "PatternDetectorConfig", "DetectedPattern",
    "PATTERN_DAILY", "PATTERN_WEEKLY", "PATTERN_BURST", "PATTERN_GROWING",
    "PATTERN_DECAYING",
    "RelationshipEvolution", "RelationshipConfig", "RelationshipTrend",
    "DecayIntegration", "DecayIntegrationConfig", "DecayModifier",
    "DecayComponent", "conservative_decay_config", "aggressive_decay_config",
]

"""Scene-change detection."""
from .detect import (  # noqa: F401
    SceneDetector,
    SceneFlags,
    StreamSceneDetector,
    frame_stats,
    scene_detect,
)

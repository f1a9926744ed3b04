"""Host video and image IO: ``.y4m`` in numpy, other containers through
OpenCV (imported only where a function opens such a file)."""

from .stream import FrameReader, process_video, stream_batches  # noqa: F401
from .video import (  # noqa: F401
    export_reference_frames,
    parse_ref_num,
    read_image,
    read_reference_dir,
    read_video,
    ref_frame_name,
    write_image,
    write_video,
    write_video_y4m,
)
from .y4m import Y4MReader  # noqa: F401

"""Video decode on the host, once, at full resolution.

The port of the JAX package's `data/frames.py` (reference
src/datasets/generate_frames.py:7-55). The decoder is cv2.VideoCapture, as
in the JAX package: both packages then read the same frames of a clip, and
everything after the decode can be held against the JAX package on equal
inputs. (A Pillow decode of an MJPG AVI's JPEG payloads differs from
VideoCapture's, which goes through ffmpeg's MJPEG decoder, by up to 32
levels on data/vids/balloons_pan.avi.) There is no second decoder to fall
back on: a clip cv2 cannot read raises.
"""

from __future__ import annotations

import os

import numpy as np


def _open(video_path: str):
    import cv2

    if not os.path.exists(video_path):
        raise FileNotFoundError(f"invalid path: {video_path}")
    capture = cv2.VideoCapture(video_path)
    if not capture.isOpened():
        capture.release()
        raise ValueError(f"cv2 cannot open video: {video_path} "
                         "(corrupt file or unsupported codec?)")
    return cv2, capture


def video_to_frames(video_path: str, start_frame: int = 0,
                    max_frames: int = 13) -> np.ndarray:
    """Decode up to max_frames RGB frames from start_frame. Returns
    (T, H, W, 3) uint8. Frames that fail to decode are skipped, up to 500
    in a row (generate_frames.py:27-41)."""
    cv2, capture = _open(video_path)
    try:
        total_frames = int(capture.get(cv2.CAP_PROP_FRAME_COUNT))
        if not total_frames > start_frame >= 0:
            raise ValueError(f"start frame {start_frame} out of range: "
                             f"{video_path} has {total_frames} frames")
        end = min(max_frames, total_frames - start_frame)
        capture.set(cv2.CAP_PROP_POS_FRAMES, start_frame)
        frames, misses = [], 0
        while len(frames) < end and misses <= 500:
            _, image = capture.read()
            if image is None:
                misses += 1
                continue
            misses = 0
            frames.append(cv2.cvtColor(image, cv2.COLOR_BGR2RGB))
    finally:
        capture.release()
    if not frames:
        raise ValueError(f"no frame of {video_path} could be decoded")
    return np.stack(frames)


def video_metadata(video_path: str):
    """(org_fps, height, width) without decoding (reference video.py:28-31)."""
    cv2, capture = _open(video_path)
    try:
        fps = capture.get(cv2.CAP_PROP_FPS)
        h = capture.get(cv2.CAP_PROP_FRAME_HEIGHT)
        w = capture.get(cv2.CAP_PROP_FRAME_WIDTH)
    finally:
        capture.release()
    if not (fps > 0 and h > 0 and w > 0):
        raise ValueError(f"cv2 reports degenerate metadata for "
                         f"{video_path}: fps={fps}, h={h}, w={w}")
    return fps, h, w

"""Camera perception for real-robot deployment: AprilTag localization.

Copy of ``rsr_mjx_tpu/deploy/perception.py``.

Transport-agnostic rebuild of the reference's ROS perception nodes:

- AprilTag 16H5 detection + solvePnP + fixed camera→base extrinsics
  publishing the cube position (reference:
  airbot_sim2real_sl/scripts/marker_pose_publisher.py:29-118)
- the two-tag T-shape variant emitting point0/point1 plus the offset
  approach point `new_point` (airbot_t/scripts/marker_pose_publisher.py:46-109)
- threaded frame capture with a bounded drop-oldest queue and AprilTag
  extrinsic self-calibration (airbot_sim2real_sl/scripts/real_sensor.py:35-176)

Design changes vs the reference: no ROS dependency — localizers are pure
``frame -> point`` functions and publishing is a callback; the RealSense
SDK is optional (any ``FrameSource`` works, including the synthetic one
used by the unit tests); camera intrinsics/extrinsics live in a dataclass
instead of a global YAML (config surface mirrors config/config.yaml).

Everything here is host-side numpy/OpenCV; it feeds the control loops in
deploy/control_loop.py (``get_marker_position``) and deploy/t_push.py,
which run the policy (deploy/policy.py).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

try:
  import cv2
except ImportError:  # pragma: no cover - cv2 is present in CI
  cv2 = None


def _require_cv2():
  if cv2 is None:
    raise ImportError('perception requires OpenCV (cv2)')


# Fixed camera→base extrinsic of the reference rig
# (marker_pose_publisher.py:37-41): the camera looks straight down at the
# table from 0.738 m with a 180° flip about x.
REFERENCE_CAM_TO_BASE = np.array([
    [9.99999995e-01, -7.59005975e-07, -9.75572810e-05, 5.74032376e-02],
    [-7.58053908e-07, -1.00000000e+00, 9.75908905e-06, 5.73699780e-03],
    [-9.75572884e-05, -9.75901505e-06, -9.99999995e-01, 7.38194332e-01],
    [0.0, 0.0, 0.0, 1.0],
])

# Default intrinsics/distortion of the reference camera (config.yaml).
REFERENCE_INTRINSICS = np.array([
    [631.3515625, 0.0, 626.600891113281],
    [0.0, 630.687866210938, 370.291473388672],
    [0.0, 0.0, 1.0],
])
REFERENCE_DISTORTION = np.array([
    -0.0550069771707058, 0.0681830942630768, -0.000741528230719268,
    0.000695949769578874, -0.0215765833854675,
])


@dataclasses.dataclass
class CameraConfig:
  """Camera + tag geometry (reference: config/config.yaml realsense block)."""

  intrinsics: np.ndarray = dataclasses.field(
      default_factory=lambda: REFERENCE_INTRINSICS.copy()
  )
  distortion: np.ndarray = dataclasses.field(
      default_factory=lambda: REFERENCE_DISTORTION.copy()
  )
  tag_length: float = 0.04  # metres (config.yaml tag_length)
  cam_to_base: np.ndarray = dataclasses.field(
      default_factory=lambda: REFERENCE_CAM_TO_BASE.copy()
  )
  # base-frame fixups applied after the extrinsic transform
  # (marker_pose_publisher.py:101-104): x mirrored + offset, y mirrored.
  x_offset: float = 0.57
  flip_xy: bool = True

  @classmethod
  def from_yaml(cls, path: str) -> 'CameraConfig':
    """Load from the deployment config.yaml (deploy_ros/.../config.yaml;
    reference: airbot_sim2real_sl/config/config.yaml structure)."""
    import yaml

    with open(path) as f:
      doc = yaml.safe_load(f)
    kwargs = {}
    cam = doc.get('camera', {})
    if 'intrinsics' in cam:
      kwargs['intrinsics'] = np.asarray(
          cam['intrinsics'], dtype=np.float64
      ).reshape(3, 3)
    if 'distortions' in cam:
      kwargs['distortion'] = np.asarray(cam['distortions'], np.float64)
    tag = doc.get('tag', {})
    if 'length' in tag:
      kwargs['tag_length'] = float(tag['length'])
    return cls(**kwargs)


def tag_object_points(tag_length: float) -> np.ndarray:
  """Planar tag corner coordinates in the tag frame, in OpenCV aruco corner
  order (top-left, top-right, bottom-right, bottom-left — the ordering the
  reference uses for PnP, marker_pose_publisher.py:91-96)."""
  l = tag_length / 2.0
  return np.array(
      [[-l, +l, 0.0], [+l, +l, 0.0], [+l, -l, 0.0], [-l, -l, 0.0]],
      dtype=np.float64,
  )


class TagDetector:
  """AprilTag 16H5 detector (reference marker_pose_publisher.py:43-45)."""

  def __init__(self, dictionary: str = 'DICT_APRILTAG_16H5'):
    _require_cv2()
    tag_dict = cv2.aruco.getPredefinedDictionary(
        getattr(cv2.aruco, dictionary)
    )
    params = cv2.aruco.DetectorParameters()
    self._detector = cv2.aruco.ArucoDetector(tag_dict, params)

  def detect(self, image: np.ndarray) -> Dict[int, np.ndarray]:
    """Detect tags; returns {tag_id: (4, 2) pixel corners}.

    Accepts BGR or grayscale frames."""
    if image.ndim == 3:
      image = cv2.cvtColor(image, cv2.COLOR_BGR2GRAY)
    corners, ids, _ = self._detector.detectMarkers(image)
    if ids is None:
      return {}
    return {
        int(i): np.asarray(c).reshape(4, 2)
        for i, c in zip(ids.reshape(-1), corners)
    }


def solve_tag_camera_pos(
    corners: np.ndarray, cfg: CameraConfig
) -> Optional[np.ndarray]:
  """Tag center position in the camera frame via solvePnP, or None."""
  _require_cv2()
  ok, _rvec, tvec = cv2.solvePnP(
      tag_object_points(cfg.tag_length),
      np.asarray(corners, dtype=np.float64).reshape(4, 2),
      np.asarray(cfg.intrinsics, dtype=np.float64),
      np.asarray(cfg.distortion, dtype=np.float64),
  )
  if not ok:
    return None
  return np.asarray(tvec, dtype=np.float64).reshape(3)


def camera_to_base(tvec: np.ndarray, cfg: CameraConfig) -> np.ndarray:
  """Camera-frame tag position → robot-base frame point with the
  reference's mirror/offset fixups (marker_pose_publisher.py:99-104)."""
  point = cfg.cam_to_base @ np.append(np.asarray(tvec, np.float64), 1.0)
  point = point[:3]
  if cfg.flip_xy:
    point[0] = -point[0] + cfg.x_offset
    point[1] = -point[1]
  return point


class MarkerLocalizer:
  """Single-tag (cube) localizer: frame → base-frame cube position.

  Equivalent of the /qr_coordinates publisher loop
  (marker_pose_publisher.py:75-110); `publish` is an optional callback
  taking the (3,) point (the ROS adapter plugs in here).
  """

  def __init__(
      self,
      cfg: Optional[CameraConfig] = None,
      tag_id: Optional[int] = None,
      publish: Optional[Callable[[np.ndarray], None]] = None,
  ):
    self.cfg = cfg or CameraConfig()
    self.tag_id = tag_id
    self.publish = publish
    self._detector = TagDetector()
    self.last_point: Optional[np.ndarray] = None

  def process(self, frame: np.ndarray) -> Optional[np.ndarray]:
    """Detect + localize; returns the base-frame point or None."""
    tags = self._detector.detect(frame)
    if not tags:
      return None
    if self.tag_id is not None:
      if self.tag_id not in tags:
        return None
      corners = tags[self.tag_id]
    else:  # first detection, like the reference loop over all ids
      corners = next(iter(tags.values()))
    tvec = solve_tag_camera_pos(corners, self.cfg)
    if tvec is None:
      return None
    point = camera_to_base(tvec, self.cfg)
    self.last_point = point
    if self.publish is not None:
      self.publish(point)
    return point

  def get_marker_position(self) -> Optional[np.ndarray]:
    """Control-loop contract (deploy/interface.py): latest cube xy."""
    if self.last_point is None:
      return None
    return self.last_point[:2]


class TMarkerLocalizer:
  """Two-tag T-shape localizer → (point0, point1, new_point).

  Tag 0 marks the T's vertical bar, tag 1 its base bar; `new_point` is the
  approach target 0.025 m beyond point0 along the point1→point0 direction
  (airbot_t/scripts/marker_pose_publisher.py:100-109).
  """

  APPROACH_DISTANCE = 0.025

  def __init__(
      self,
      cfg: Optional[CameraConfig] = None,
      publish: Optional[
          Callable[[str, np.ndarray], None]
      ] = None,  # (topic, point): 'point0' | 'point1' | 'new_point'
  ):
    self.cfg = cfg or CameraConfig()
    self.publish = publish
    self._detector = TagDetector()
    self.last: Dict[str, np.ndarray] = {}

  def process(
      self, frame: np.ndarray
  ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray],
             Optional[np.ndarray]]:
    tags = self._detector.detect(frame)
    point0 = point1 = new_point = None
    for tid, key in ((0, 'point0'), (1, 'point1')):
      if tid not in tags:
        continue
      tvec = solve_tag_camera_pos(tags[tid], self.cfg)
      if tvec is None:
        continue
      point = camera_to_base(tvec, self.cfg)
      self.last[key] = point
      if self.publish is not None:
        self.publish(key, point)
      if tid == 0:
        point0 = point
      else:
        point1 = point
    if point0 is not None and point1 is not None:
      direction = point0 - point1
      direction = direction / np.linalg.norm(direction)
      new_point = point0 + direction * self.APPROACH_DISTANCE
      self.last['new_point'] = new_point
      if self.publish is not None:
        self.publish('new_point', new_point)
    return point0, point1, new_point


def extrinsic_self_calibration(
    frame: np.ndarray, cfg: CameraConfig
) -> Optional[np.ndarray]:
  """Camera-to-world from one AprilTag observation: c2w = [Rᵀ | −Rᵀt]
  (reference real_sensor._get_extrinsic, real_sensor.py:131-176)."""
  _require_cv2()
  detector = TagDetector()
  tags = detector.detect(frame)
  if not tags:
    return None
  corners = next(iter(tags.values()))
  ok, rvec, tvec = cv2.solvePnP(
      tag_object_points(cfg.tag_length),
      np.asarray(corners, dtype=np.float64).reshape(4, 2),
      np.asarray(cfg.intrinsics, dtype=np.float64),
      np.asarray(cfg.distortion, dtype=np.float64),
  )
  if not ok:
    return None
  rmat, _ = cv2.Rodrigues(rvec)
  c2w = np.eye(4)
  c2w[:3, :3] = rmat.T
  c2w[:3, 3] = -rmat.T @ np.asarray(tvec).flatten()
  return c2w


# ---------------------------------------------------------------------------
# Frame sources: threaded capture with a bounded drop-oldest queue
# (reference RealSense class, real_sensor.py:15-127).
# ---------------------------------------------------------------------------


class FrameSource:
  """Capture interface: ``capture() -> frame dict or None``.

  Frame dict keys follow the reference: 'timestamp', 'color' (H, W, 3)
  BGR uint8, optionally 'depth' (H, W) uint16."""

  def capture(self) -> Optional[dict]:
    raise NotImplementedError

  def close(self) -> None:
    pass


class ThreadedCameraSource:
  """Threaded wrapper that polls a FrameSource and keeps a bounded queue.

  Mirrors the reference RealSense threading/queue/stop-event structure
  (real_sensor.py:31-41, :92-127): frames are dropped oldest-first past
  ``max_queue_size``; ``get`` blocks up to ``timeout`` seconds.  An
  optional extrinsic self-calibration runs once at startup and is attached
  to every frame, like the reference's ``_get_extrinsic``."""

  def __init__(
      self,
      source: FrameSource,
      cfg: Optional[CameraConfig] = None,
      max_queue_size: int = 1,
      self_calibrate: bool = False,
  ):
    self._source = source
    self.cfg = cfg or CameraConfig()
    self._max_queue_size = max(int(max_queue_size), 1)
    self._self_calibrate = self_calibrate
    self._queue: queue.Queue = queue.Queue()
    self._stop = threading.Event()
    self._thread: Optional[threading.Thread] = None
    self.extrinsics: Optional[np.ndarray] = None

  def start(self) -> None:
    self._thread = threading.Thread(target=self._run, daemon=True)
    self._thread.start()

  def _run(self) -> None:
    if self._self_calibrate:
      frame = self._source.capture()
      if frame is not None:
        self.extrinsics = extrinsic_self_calibration(
            frame['color'], self.cfg
        )
    while not self._stop.is_set():
      frame = self._source.capture()
      if frame is None:
        continue
      frame = dict(frame)
      frame.setdefault('timestamp', time.time())
      frame['extrinsics'] = self.extrinsics
      self._queue.put(frame)
      while self._queue.qsize() > self._max_queue_size:
        try:
          self._queue.get_nowait()
        except queue.Empty:
          break

  def get(self, timeout: float = 1.0) -> Optional[dict]:
    try:
      return self._queue.get(timeout=timeout)
    except queue.Empty:
      return None

  def stop(self) -> None:
    self._stop.set()
    if self._thread is not None:
      self._thread.join(timeout=5.0)
    self._source.close()


class RealSenseSource(FrameSource):
  """Intel RealSense capture (optional; requires pyrealsense2).

  Aligned color+depth streams and intrinsics read from the device,
  mirroring real_sensor.py:16-33, :66-127."""

  def __init__(self, width: int = 1280, height: int = 720, fps: int = 30):
    try:
      import pyrealsense2 as rs  # type: ignore
    except ImportError as e:  # pragma: no cover - hardware SDK
      raise ImportError('RealSenseSource requires pyrealsense2') from e
    self._rs = rs
    self._pipeline = rs.pipeline()
    config = rs.config()
    config.enable_stream(rs.stream.color, width, height, rs.format.bgr8, fps)
    config.enable_stream(rs.stream.depth, width, height, rs.format.z16, fps)
    self._align = rs.align(rs.stream.color)
    profile = self._pipeline.start(config)
    ci = (
        profile.get_stream(rs.stream.color)
        .as_video_stream_profile()
        .get_intrinsics()
    )
    self.intrinsics = np.array(
        [[ci.fx, 0, ci.ppx], [0, ci.fy, ci.ppy], [0, 0, 1]]
    )
    self.distortion = np.asarray(ci.coeffs)

  def capture(self) -> Optional[dict]:  # pragma: no cover - hardware
    frames = self._pipeline.wait_for_frames()
    aligned = self._align.process(frames)
    color = aligned.get_color_frame()
    depth = aligned.get_depth_frame()
    if not color or not depth:
      return None
    return {
        'timestamp': time.time(),
        'color': np.asanyarray(color.get_data()),
        'depth': np.asanyarray(depth.get_data()),
    }

  def close(self) -> None:  # pragma: no cover - hardware
    self._pipeline.stop()


class PerceptionPipeline:
  """Camera → localizer glue satisfying the control loop's marker contract.

  Continuously processes frames from a ThreadedCameraSource through a
  MarkerLocalizer (or TMarkerLocalizer) and exposes
  ``get_marker_position()`` for deploy/control_loop.py.  The
  ``on_step_complete(step)`` hook saves the current frame to
  ``frame_dir/id_<n>.jpg`` like the reference's step_complete subscriber
  (marker_pose_publisher.py:57-70).
  """

  def __init__(
      self,
      camera: ThreadedCameraSource,
      localizer,
      frame_dir: Optional[str] = None,
  ):
    self.camera = camera
    self.localizer = localizer
    self.frame_dir = frame_dir
    self._frame_count = 0
    self._last_frame: Optional[dict] = None

  def poll(self, timeout: float = 1.0):
    """Fetch the next frame and run the localizer; returns its output."""
    frame = self.camera.get(timeout=timeout)
    if frame is None:
      return None
    self._last_frame = frame
    return self.localizer.process(frame['color'])

  def get_marker_position(self) -> Optional[np.ndarray]:
    self.poll(timeout=0.1)
    getter = getattr(self.localizer, 'get_marker_position', None)
    if getter is not None:
      return getter()
    return None

  def on_step_complete(self, step: int) -> None:
    if self.frame_dir is None or self._last_frame is None:
      return
    _require_cv2()
    import os

    os.makedirs(self.frame_dir, exist_ok=True)
    self._frame_count += 1
    path = os.path.join(self.frame_dir, f'id_{self._frame_count}.jpg')
    cv2.imwrite(path, self._last_frame['color'])

"""A stand-in for ``mujoco.Renderer`` for tests on machines with no GL
context: it records what the port's ``render_array`` asks of it and
returns frames filled with their index.  ``install(monkeypatch)`` puts it
in place of ``mujoco.Renderer`` and returns the list of its instances."""

import numpy as np


class StubRenderer:

  instances = None

  def __init__(self, model, height=240, width=320):
    import mujoco

    self.model, self.height, self.width = model, height, width
    self.scene = mujoco.MjvScene(model, maxgeom=64)
    self.cameras, self.qpos, self.decor, self.closed = [], [], [], False
    StubRenderer.instances.append(self)

  def update_scene(self, data, camera=None, scene_option=None):
    self.cameras.append(camera)
    self.qpos.append(np.array(data.qpos))
    self.scene.ngeom = 0  # as a fresh scene of the frame

  def render(self):
    # the decoration geoms a modify_scene hook added to this frame
    self.decor.append([self.scene.geoms[i].type
                       for i in range(self.scene.ngeom)])
    return np.full((self.height, self.width, 3), len(self.qpos) - 1,
                   np.uint8)

  def close(self):
    self.closed = True


def install(monkeypatch):
  import mujoco

  StubRenderer.instances = []
  monkeypatch.setattr(mujoco, 'Renderer', StubRenderer)
  return StubRenderer.instances

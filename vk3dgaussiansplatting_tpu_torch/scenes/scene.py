"""Scene framework — port of `vk3dgaussiansplatting_tpu.scenes.scene`.

The reference's Application layer (Scene.h:7-41, SceneManager.{h,cpp}):
a scene owns a camera and populates its gaussians in `init`; the
SceneManager performs the deferred scene swap and re-binds the renderer
(`Renderer::initForScene`, SceneManager.cpp:53-70).
"""

from __future__ import annotations

from ..models.gaussians import GaussianTable, concat_tables
from ..render.camera import Camera


class Scene:
    """Abstract scene (reference: Scene.h:36-37)."""

    def __init__(self, aspect: float = 16.0 / 9.0):
        self.camera = Camera(aspect)
        self._tables: list[GaussianTable] = []
        self._loaded: GaussianTable | None = None

    def add_gaussians(self, table: GaussianTable) -> None:
        self._tables.append(table)

    def load_gaussians(self, path: str) -> None:
        """Add the gaussians of a .ply file (ResourceManager::loadGaussians)."""
        from ..io.ply import load_gaussians

        self._tables.append(load_gaussians(path))

    def gaussians(self) -> GaussianTable:
        if self._loaded is None:
            if not self._tables:
                raise RuntimeError("scene has no gaussians")
            self._loaded = (
                self._tables[0] if len(self._tables) == 1 else concat_tables(self._tables)
            )
        return self._loaded

    def init(self) -> None:  # populate camera + gaussians
        raise NotImplementedError

    def update(self, dt: float = 0.0) -> None:
        self.camera.update(None, dt)


class SceneManager:
    """Deferred scene switching (SceneManager.cpp:53-70): `set_scene`
    queues a scene, and `update_to_next_scene` (the frame loop's first step)
    initialises it and binds the renderer to its gaussians."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.current: Scene | None = None
        self._next: Scene | None = None

    def set_scene(self, scene: Scene) -> None:
        self._next = scene

    def update_to_next_scene(self) -> None:
        if self._next is not None:
            scene, self._next = self._next, None
            scene.init()
            scene.camera.set_aspect(self.renderer.config.width / self.renderer.config.height)
            self.renderer.init_for_scene(scene.gaussians())
            self.current = scene

    def update(self, dt: float = 0.0) -> None:
        if self.current is not None:
            self.current.update(dt)

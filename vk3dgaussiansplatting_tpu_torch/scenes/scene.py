"""Scene base class (reference: Scene.h:7-41): a scene owns a camera and
populates its gaussians in `init`."""

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

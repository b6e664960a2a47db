"""Reference ellipsoids (a copy of ``aerial_image_recognition_tpu/geo/ellipsoid.py``)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class Ellipsoid:
    a: float          # semi-major axis [m]
    f: float          # flattening

    @property
    def b(self) -> float:
        return self.a * (1.0 - self.f)

    @property
    def e2(self) -> float:
        """First eccentricity squared."""
        return self.f * (2.0 - self.f)

    @property
    def e(self) -> float:
        return self.e2 ** 0.5

    @property
    def n(self) -> float:
        """Third flattening."""
        return self.f / (2.0 - self.f)


WGS84 = Ellipsoid(a=6378137.0, f=1.0 / 298.257223563)
GRS80 = Ellipsoid(a=6378137.0, f=1.0 / 298.257222101)

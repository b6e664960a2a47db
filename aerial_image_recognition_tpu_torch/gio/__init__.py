"""gio layer of the PyTorch port: image decode, GeoJSON, ESRI shapefile,
GeoTIFF and GeoPackage IO (copies of the reference's pure-Python
modules; the same exports as ``aerial_image_recognition_tpu/gio``)."""

from aerial_image_recognition_tpu_torch.gio.geojson import (  # noqa: F401
    detections_to_feature_collection, feature_collection_to_detections,
    coverage_to_feature_collection, read_geojson, read_polygons,
    write_geojson,
)
from aerial_image_recognition_tpu_torch.gio.shapefile import (  # noqa: F401
    ShapeRecord, detections_to_shapefile, read_dbf, read_polygons_shp,
    read_shapefile, write_shapefile,
)
from aerial_image_recognition_tpu_torch.gio.geotiff import (  # noqa: F401
    GeoTiff, read_geotiff, write_geotiff,
)

"""The fetch plane: XYZ, WMS and WMTS fetchers over a resilient HTTP layer
(a copy of ``aerial_image_recognition_tpu/fetch/``)."""

from aerial_image_recognition_tpu_torch.fetch.http import TileHTTP, FetchStats, FailureLog
from aerial_image_recognition_tpu_torch.fetch.cache import TileCache
from aerial_image_recognition_tpu_torch.fetch.xyz import XYZFetcher, TileImage
from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher
from aerial_image_recognition_tpu_torch.fetch.wmts import WMTSFetcher, TileMatrix

"""Asyncio facade over the fetch plane.

A copy of ``aerial_image_recognition_tpu/fetch/aio.py``.

The reference's monolith drives fetching with asyncio + aiohttp
(simple_detector.py:59-93,112-200). The port does not depend on aiohttp: its
fetchers are thread-pool based; these wrappers restore the async surface
(await get_image / gather batches) for users porting asyncio code — each
call is the same resilient fetcher hopped onto the default executor.
"""

import asyncio
from functools import partial
from typing import List, Optional, Sequence

from aerial_image_recognition_tpu_torch.fetch.xyz import TileImage, XYZFetcher
from aerial_image_recognition_tpu_torch.fetch.wms import WMSFetcher


class AsyncXYZ:
    def __init__(self, fetcher: XYZFetcher):
        self.fetcher = fetcher

    async def get_image(self, lat: float, lon: float,
                        target_size_m: Optional[float] = None,
                        window_px: Optional[int] = None
                        ) -> Optional[TileImage]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, partial(self.fetcher.get_image, lat, lon,
                          target_size_m, window_px=window_px))

    async def fetch_batch(self, bboxes: Sequence,
                          window_px: Optional[int] = None
                          ) -> List[Optional[TileImage]]:
        # concurrency comes from the fetcher's own pools; gather preserves
        # the asyncio.gather(get_image×N) call shape of the reference
        return await asyncio.gather(*[
            self.get_image((b[1] + b[3]) / 2, (b[0] + b[2]) / 2,
                           window_px=window_px) for b in bboxes])


class AsyncWMS:
    def __init__(self, fetcher: WMSFetcher):
        self.fetcher = fetcher

    async def get_single_image(self, bbox) -> Optional[TileImage]:
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, self.fetcher.get_single_image, bbox)

    async def fetch_batch(self, bboxes: Sequence) -> List[Optional[TileImage]]:
        return await asyncio.gather(*[self.get_single_image(b)
                                      for b in bboxes])

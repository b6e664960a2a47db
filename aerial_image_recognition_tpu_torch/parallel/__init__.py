"""parallel layer of the PyTorch port: meshes of devices, the striped halo
dedup, torch.distributed processes (see the package docstring)."""

from aerial_image_recognition_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh, make_mesh, mesh_from_flag, pad_to_multiple, replicate,
    shard_batch,
)
from aerial_image_recognition_tpu_torch.parallel.stripes import (  # noqa: F401
    assign_to_stripes, halo_dedup_host, make_halo_dedup, split_aoi_stripes,
)

"""refraction: a GPU ray-tracing framework in JAX (XLA + Pallas).

From-scratch reimplementation of the capabilities of the DXR demo
`bottledspace/refraction-raytracing-dxr` — OBJ/HDR asset ingest, an orbiting
pinhole camera, and recursive dielectric refraction with Fresnel-weighted
reflection shaded against an equirectangular environment map — with the
entire DXR hardware layer (acceleration structures, TraceRay, shader
scheduling) replaced by a software wavefront path tracer: static-shape ray
pools, a cluster-culling Pallas intersection kernel for the GPU, and
shard_map image sharding over device meshes.
"""

__version__ = "0.1.0"

from refraction.config import RenderConfig, baseline_config, reference_config  # noqa: F401

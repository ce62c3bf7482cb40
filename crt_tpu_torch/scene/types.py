"""Scene data model: frozen dataclasses of tensors.

Counterpart of ``crt_tpu/scene/types.py``: the same field names, the same
material / texture codes, the same ``RenderSettings`` fields and derived
properties.  Where the JAX package registers pytrees with static meta
fields, the port keeps plain frozen dataclasses whose tensors move together
with ``.to(device)``; the device a render runs on is the device of the
scene's tensors.  Every function that builds a scene takes ``device=None``,
which ``resolve_device`` reads as the card.  ``Scene.accel`` is the KD
tree of the tree backend (``AccelTree``), built at load.
"""

from __future__ import annotations

import dataclasses

import torch

# Material type codes (crt_tpu/scene/types.py).
MATERIAL_DIFFUSE = 0
MATERIAL_REFLECTIVE = 1
MATERIAL_REFRACTIVE = 2
MATERIAL_CONSTANT = 3

MATERIAL_TYPE_NAMES = ("diffuse", "reflective", "refractive", "constant")

# Texture type codes.
TEXTURE_ALBEDO = 0
TEXTURE_EDGES = 1
TEXTURE_CHECKER = 2
TEXTURE_BITMAP = 3

TEXTURE_TYPE_NAMES = ("albedo", "edges", "checker", "bitmap")

DEFAULT_SCENE_BUCKET_SIZE = 24
DEFAULT_MAX_RAY_DEPTH = 3
DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT = 4
DEFAULT_SHADOW_BIAS = 1e-2
DEFAULT_REFLECTION_BIAS = 1e-2
DEFAULT_DIFFUSE_REFLECTION_BIAS = 1e-2
DEFAULT_REFRACTION_BIAS = 1e-2

# Acceleration-tree constants (the reference's crt_acceleration_tree.h).
MAX_ACCELERATION_TREE_DEPTH = 39
MAX_BOX_TRIANGLE_COUNT = 16


def resolve_device(device=None) -> torch.device:
    """The device a scene is built on.  ``None`` is the card (``cuda``);
    asking for the card, by name or by default, on a machine that shows
    none raises instead of carrying on on the CPU.  Pass ``"cpu"`` to run
    the plain versions on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "crt_tpu_torch runs on a CUDA device and none is visible; "
            'pass device="cpu" to run on the CPU')
    return dev


# Tensor fields of Scene, in declaration order.
SCENE_TENSOR_FIELDS = (
    "vertices",
    "vertex_normals",
    "vertex_uvs",
    "tri_vidx",
    "tri_material",
    "mat_type",
    "mat_albedo_tex",
    "mat_ior",
    "mat_smooth",
    "mat_backface",
    "tex_type",
    "tex_color_a",
    "tex_color_b",
    "tex_scalar",
    "tex_bitmap",
    "bitmap_data",
    "bitmap_size",
    "light_position",
    "light_intensity",
    "cam_position",
    "cam_rotation",
    "cam_tan_half_fov",
    "background_color",
)

# Static metadata fields of Scene.
SCENE_META_FIELDS = (
    "width",
    "height",
    "bucket_size",
    "gi_on",
    "reflections_on",
    "refractions_on",
    "has_reflective",
    "has_refractive",
    "has_constant",
    "has_materials",
    "has_lights",
    "any_smooth",
    "texture_types_present",
)


# Tensor and static fields of AccelTree, in declaration order.
ACCEL_TENSOR_FIELDS = (
    "node_min",
    "node_max",
    "node_children",
    "node_leaf_id",
    "leaf_tris",
    "leaf_node",
)
ACCEL_META_FIELDS = ("leaf_size", "num_nodes", "num_leaves")


@dataclasses.dataclass(frozen=True)
class AccelTree:
    """Flattened midpoint-split KD/AABB tree: node boxes, child ids, and a
    padded ``[num_leaves, leaf_size]`` triangle-id table (``-1`` pads), so
    a leaf is one row of one gather."""

    node_min: torch.Tensor  # [N, 3] f32 AABB lower corner
    node_max: torch.Tensor  # [N, 3] f32 AABB upper corner
    node_children: torch.Tensor  # [N, 2] i32, -1 = absent child
    node_leaf_id: torch.Tensor  # [N] i32 row into leaf_tris, -1 = internal
    leaf_tris: torch.Tensor  # [num_leaves, leaf_size] i32, -1 pad
    leaf_node: torch.Tensor  # [num_leaves] i32 owning node id
    leaf_size: int = MAX_BOX_TRIANGLE_COUNT
    num_nodes: int = 0
    num_leaves: int = 0

    def to(self, device) -> "AccelTree":
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device)
                     for f in ACCEL_TENSOR_FIELDS})


@dataclasses.dataclass(frozen=True)
class Scene:
    """Render-ready scene as one struct of tensors."""

    # Geometry
    vertices: torch.Tensor  # [V, 3] f32
    vertex_normals: torch.Tensor  # [V, 3] f32 accumulated smooth normals
    vertex_uvs: torch.Tensor  # [V, 3] f32
    tri_vidx: torch.Tensor  # [T, 3] i32 CCW vertex indices
    tri_material: torch.Tensor  # [T] i32
    # Materials
    mat_type: torch.Tensor  # [M] i32 MATERIAL_* codes
    mat_albedo_tex: torch.Tensor  # [M] i32 texture index (-1 for refractive)
    mat_ior: torch.Tensor  # [M] f32
    mat_smooth: torch.Tensor  # [M] bool
    mat_backface: torch.Tensor  # [M] bool
    # Textures
    tex_type: torch.Tensor  # [X] i32 TEXTURE_* codes
    tex_color_a: torch.Tensor  # [X, 3] f32
    tex_color_b: torch.Tensor  # [X, 3] f32
    tex_scalar: torch.Tensor  # [X] f32 edge_width / square_size
    tex_bitmap: torch.Tensor  # [X] i32 row into bitmap_data, -1 = none
    bitmap_data: torch.Tensor  # [B, Hmax, Wmax, 3] f32
    bitmap_size: torch.Tensor  # [B, 2] i32
    # Lights
    light_position: torch.Tensor  # [L, 3] f32
    light_intensity: torch.Tensor  # [L] f32
    # Camera
    cam_position: torch.Tensor  # [3] f32
    cam_rotation: torch.Tensor  # [3, 3] f32 row-major, row-vector convention
    cam_tan_half_fov: torch.Tensor  # [] f32
    # Misc
    background_color: torch.Tensor  # [3] f32
    # Acceleration structure (the tree backend); None when not built
    accel: AccelTree | None = None
    # Static metadata
    width: int = 0
    height: int = 0
    bucket_size: int = DEFAULT_SCENE_BUCKET_SIZE
    gi_on: bool = False
    reflections_on: bool = True
    refractions_on: bool = True
    has_reflective: bool = False
    has_refractive: bool = False
    has_constant: bool = False
    has_materials: bool = True
    has_lights: bool = True
    any_smooth: bool = False
    texture_types_present: tuple = ()

    @property
    def device(self) -> torch.device:
        return self.vertices.device

    @property
    def num_triangles(self) -> int:
        return int(self.tri_vidx.shape[0])

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_position.shape[0])

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in SCENE_TENSOR_FIELDS}

    def to(self, device) -> "Scene":
        accel = None if self.accel is None else self.accel.to(device)
        return self.replace(accel=accel, **{k: v.to(device) for k, v in
                                            self.tensors().items()})

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Counterpart of ``crt_tpu.scene.types.RenderSettings``.

    Every field is accepted so settings written for crt_tpu carry over.
    ``head_compat`` switches on the three reference quirks (no shadows, the
    unconditional GI divide, the Hadamard y typo).  ``backend``: "cluster" is
    the binned cluster trace (its CUDA kernels on a CUDA scene, their plain
    versions on a CPU scene) and "pallas" its alias; "stream" is the
    two-level streaming trace for large scenes and "pallas_stream" its
    alias; "auto" is the cluster trace, and on the card the streaming trace
    above ``renderer.AUTO_STREAM_MIN_CLUSTERS`` clusters; "bruteforce" is
    the all-pairs backend; "tree" walks ``Scene.accel``, the KD tree
    (a kernel a walk on the card; "auto" never takes it).  ``stream_shadow_k`` is the phase-1 depth of the
    streaming trace's two-phase shadow resolve (0: one phase; the image
    does not depend on it).  ``wavefront``: "auto" takes the
    iterative bank wavefront for a scene with live refraction at depth >= 2
    or with GI and the unrolled recursion otherwise; "iter" / "recursive"
    force one.  ``wavefront_banks`` overrides the pool's bank count (0:
    f^depth under GI, f = max(K, 2 with glass); 2^min(depth, 3) with glass
    otherwise), ``wavefront_sched`` picks its schedule ("scan", "grow";
    "auto" is grow under GI, scan otherwise).
    ``diffuse_reflection_ray_count`` is K, the GI samples a diffuse hit of
    a ``gi_on`` scene.  ``compact_bounces`` sends every masked trace through
    the live-tile compacted closest-hit kernel (the same image, bit for
    bit).  ``remat_shading`` keeps no graph of an iterative bounce and runs
    it again in the backward (the same gradients, less memory).  ``aov``
    names an auxiliary pass (``renderer.AOVS``) that ``render_image``
    renders instead of the beauty image.  Fields
    that only tune the TPU package (``shadow_tile_rays``,
    ``fused_light_vjp``) change no output and are
    accepted as no-ops.
    """

    max_ray_depth: int = DEFAULT_MAX_RAY_DEPTH
    diffuse_reflection_ray_count: int = DEFAULT_DIFFUSE_REFLECTION_RAY_COUNT
    shadow_bias: float = DEFAULT_SHADOW_BIAS
    reflection_bias: float = DEFAULT_REFLECTION_BIAS
    diffuse_reflection_bias: float = DEFAULT_DIFFUSE_REFLECTION_BIAS
    refraction_bias: float = DEFAULT_REFRACTION_BIAS
    head_compat: bool = False
    compat_no_shadows: bool = False
    compat_gi_divide: bool = False
    compat_hadamard_y: bool = False
    backend: str = "auto"
    chunk_pixels: int = 0
    wavefront: str = "auto"
    wavefront_banks: int = 0
    wavefront_sched: str = "auto"
    remat_shading: bool = False
    compact_bounces: bool = False
    shadow_tile_rays: int = 0
    fused_light_vjp: bool = False
    stream_shadow_k: int = 2
    aov: str = ""

    @property
    def no_shadows(self) -> bool:
        return self.head_compat or self.compat_no_shadows

    @property
    def gi_divide(self) -> bool:
        return self.head_compat or self.compat_gi_divide

    @property
    def hadamard_y(self) -> bool:
        return self.head_compat or self.compat_hadamard_y

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

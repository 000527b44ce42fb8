// Kernels B1s, B2s and B4s: the tile blend forward of surfels (2D Gaussian
// splatting), the MODE kSurfel instantiations of tile_raster_fwd.cu's
// template (its header describes them), in a library of their own so that
// a 3DGS render never builds or loads them.  The entry points are
// tile_raster_fwd.cu's, with the same signatures; mode 0 selects the
// surfel kernel and any other mode is refused.

#define GSV_FWD_SURFEL
#include "tile_raster_fwd.cu"

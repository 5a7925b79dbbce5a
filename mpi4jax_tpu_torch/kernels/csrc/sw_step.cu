// Hand-written Hopper (sm_90a) kernels for the shallow-water wide-halo
// (ghost-2) step.
//
//   sw_main  replaces research/sw_step_pallas.py:_main_kernel (launched
//            by _call_main): fluxes, potential vorticity, kinetic energy,
//            all tendencies and the AB2 (or Euler) update.
//   sw_visc  replaces research/sw_step_pallas.py:_visc_kernel (launched
//            by _call_visc): the lateral-viscosity update of u and v.
//
// Layout: every field is a row-major float32 block of
// (ny_l + 4) x (nx_l + 4) cells, the interior plus a 2-deep ghost ring,
// tendencies included (the Pallas kernels' full-shaped layout).
//
// What bounds them on the card: memory.  sw_main reads six fields and
// writes six (12 x 4 B per cell) for some 80 float operations per cell;
// sw_visc reads and writes two fields each.  Both are far below the
// H100's operations-per-byte balance point, so the only thing that
// matters is to move each field once.
//
// Design (the simple first form): one thread per output cell on a 2-D
// grid of 32 x 8 blocks.  A thread reads its radius-2 neighbourhood
// straight from global memory and recomputes the ring-1 intermediates it
// needs (fe, fn, q, ke); neighbouring threads share those reads through
// L1/L2, so device memory still sees each field about once.  Every
// neighbour an interior cell reads lies in rows r-1..r+1 and columns
// c-1..c+1 of the block (the ghost ring holds the exchanged values), so
// no x wrap happens in the kernel.  Ghost cells pass their input through
// and get zero tendencies.  The Pallas kernels tile rows by 64 with 8-row
// halo blocks and keep x whole for the TPU's lanes; none of that carries
// over.  Shared-memory tiling is a later step.
//
// Numerics follow the Pallas kernels term by term (same association of
// every sum and product).  It is built without fast-math (q divides, and
// the tolerances against the plain PyTorch versions assume IEEE
// division) and without FMA contraction (-fmad=false, see _build.py):
// the y-momentum tendency is a small difference of large terms, so one
// ulp of a term would show in v.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int G = 2;  // ghost width

struct Grid {
  int rows, cols;  // full block: (ny_l + 4, nx_l + 4)
  int ny_l, nx_l;  // interior
  int is_south, is_north;  // this rank owns the southern / northern wall
};

struct MainParams {
  float dx, dy, grav, cor_f, cor_beta, dt, ab_a, ab_b;
  int iy, first_step;
};

struct ViscParams {
  float dx, dy, nu, dt;
};

__device__ __forceinline__ float at(const float* __restrict__ a,
                                    const Grid& g, int r, int c) {
  return a[static_cast<size_t>(r) * g.cols + c];
}

// Ring-1 rows beyond a wall hold zero in every intermediate field: the
// narrow schedule builds them on a zero template and the non-periodic y
// exchange never writes them (array row 1 on the south wall, row
// ny_l + 2 on the north wall).
__device__ __forceinline__ bool wall_row(const Grid& g, int r) {
  return (g.is_south && r == 1) || (g.is_north && r == g.ny_l + 2);
}

__device__ __forceinline__ bool interior(const Grid& g, int r, int c) {
  return r >= G && r < g.ny_l + G && c >= G && c < g.nx_l + G;
}

// -- ring-1 intermediates of sw_main (hc == h: the wall ghost rows of h
// were clamped to the adjacent interior row before the launch) ----------

__device__ __forceinline__ float fe_at(const float* __restrict__ h,
                                       const float* __restrict__ u,
                                       const Grid& g, int r, int c) {
  if (wall_row(g, r)) return 0.0f;
  return 0.5f * (at(h, g, r, c) + at(h, g, r, c + 1)) * at(u, g, r, c);
}

__device__ __forceinline__ float fn_at(const float* __restrict__ h,
                                       const float* __restrict__ v,
                                       const Grid& g, int r, int c) {
  // the northern flux is also zero on the last interior row (v = 0 on
  // the north wall)
  if (wall_row(g, r) || (g.is_north && r == g.ny_l + 1)) return 0.0f;
  return 0.5f * (at(h, g, r, c) + at(h, g, r + 1, c)) * at(v, g, r, c);
}

__device__ __forceinline__ float q_at(const float* __restrict__ h,
                                      const float* __restrict__ u,
                                      const float* __restrict__ v,
                                      const Grid& g, const MainParams& p,
                                      int r, int c) {
  if (wall_row(g, r)) return 0.0f;
  // Coriolis f + beta * y at the row's global y coordinate
  const float yy =
      ((static_cast<float>(r) - 2.0f) + static_cast<float>(p.iy * g.ny_l)) *
      p.dy;
  const float cor = p.cor_f + yy * p.cor_beta;
  const float rel_vort = (at(v, g, r, c + 1) - at(v, g, r, c)) / p.dx -
                         (at(u, g, r + 1, c) - at(u, g, r, c)) / p.dy;
  const float depth = 0.25f * (at(h, g, r, c) + at(h, g, r, c + 1) +
                               at(h, g, r + 1, c) + at(h, g, r + 1, c + 1));
  return (cor + rel_vort) / depth;
}

__device__ __forceinline__ float ke_at(const float* __restrict__ u,
                                       const float* __restrict__ v,
                                       const Grid& g, int r, int c) {
  if (wall_row(g, r)) return 0.0f;
  const float u0 = at(u, g, r, c), uw = at(u, g, r, c - 1);
  const float v0 = at(v, g, r, c), vs = at(v, g, r - 1, c);
  return 0.5f * (0.5f * (u0 * u0 + uw * uw) + 0.5f * (v0 * v0 + vs * vs));
}

__global__ void __launch_bounds__(256)
sw_main_kernel(const float* __restrict__ h, const float* __restrict__ u,
               const float* __restrict__ v, const float* __restrict__ dh,
               const float* __restrict__ du, const float* __restrict__ dv,
               float* __restrict__ h_out, float* __restrict__ u_out,
               float* __restrict__ v_out, float* __restrict__ dh_out,
               float* __restrict__ du_out, float* __restrict__ dv_out,
               Grid g, MainParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= g.rows || c >= g.cols) return;
  const size_t i = static_cast<size_t>(r) * g.cols + c;
  // v = 0 on the northern wall row (the last interior row), ghost
  // columns included
  const bool v_wall = g.is_north && r == g.ny_l + 1;

  if (!interior(g, r, c)) {
    h_out[i] = h[i];
    u_out[i] = u[i];
    v_out[i] = v_wall ? 0.0f : v[i];
    dh_out[i] = 0.0f;
    du_out[i] = 0.0f;
    dv_out[i] = 0.0f;
    return;
  }

  const float fe_c = fe_at(h, u, g, r, c), fe_w = fe_at(h, u, g, r, c - 1);
  const float fe_n = fe_at(h, u, g, r + 1, c);
  const float fe_nw = fe_at(h, u, g, r + 1, c - 1);
  const float fn_c = fn_at(h, v, g, r, c), fn_s = fn_at(h, v, g, r - 1, c);
  const float fn_e = fn_at(h, v, g, r, c + 1);
  const float fn_se = fn_at(h, v, g, r - 1, c + 1);
  const float q_c = q_at(h, u, v, g, p, r, c);
  const float q_s = q_at(h, u, v, g, p, r - 1, c);
  const float q_w = q_at(h, u, v, g, p, r, c - 1);
  const float ke_c = ke_at(u, v, g, r, c), ke_e = ke_at(u, v, g, r, c + 1);
  const float ke_n = ke_at(u, v, g, r + 1, c);

  const float dh_new = -(fe_c - fe_w) / p.dx - (fn_c - fn_s) / p.dy;
  float du_new = -p.grav * (at(h, g, r, c + 1) - at(h, g, r, c)) / p.dx +
                 0.5f * (q_c * 0.5f * (fn_c + fn_e) +
                         q_s * 0.5f * (fn_s + fn_se));
  float dv_new = -p.grav * (at(h, g, r + 1, c) - at(h, g, r, c)) / p.dy -
                 0.5f * (q_c * 0.5f * (fe_c + fe_n) +
                         q_w * 0.5f * (fe_w + fe_nw));
  du_new = du_new - (ke_e - ke_c) / p.dx;
  dv_new = dv_new - (ke_n - ke_c) / p.dy;

  float h_inc, u_inc, v_inc;
  if (p.first_step) {
    h_inc = p.dt * dh_new;
    u_inc = p.dt * du_new;
    v_inc = p.dt * dv_new;
  } else {
    h_inc = p.dt * (p.ab_a * dh_new + p.ab_b * dh[i]);
    u_inc = p.dt * (p.ab_a * du_new + p.ab_b * du[i]);
    v_inc = p.dt * (p.ab_a * dv_new + p.ab_b * dv[i]);
  }
  h_out[i] = h[i] + h_inc;
  u_out[i] = u[i] + u_inc;
  v_out[i] = v_wall ? 0.0f : v[i] + v_inc;
  dh_out[i] = dh_new;
  du_out[i] = du_new;
  dv_out[i] = dv_new;
}

// -- sw_visc --------------------------------------------------------------

__device__ __forceinline__ float laplacian(const float* __restrict__ w,
                                           const Grid& g,
                                           const ViscParams& p, int r,
                                           int c) {
  // viscous fluxes on ring 1, zero beyond the walls
  auto gx = [&](int rr, int cc) {
    if (wall_row(g, rr)) return 0.0f;
    return p.nu * (at(w, g, rr, cc + 1) - at(w, g, rr, cc)) / p.dx;
  };
  auto gy = [&](int rr, int cc) {
    if (wall_row(g, rr)) return 0.0f;
    return p.nu * (at(w, g, rr + 1, cc) - at(w, g, rr, cc)) / p.dy;
  };
  return (gx(r, c) - gx(r, c - 1)) / p.dx + (gy(r, c) - gy(r - 1, c)) / p.dy;
}

__global__ void __launch_bounds__(256)
sw_visc_kernel(const float* __restrict__ u, const float* __restrict__ v,
               float* __restrict__ u_out, float* __restrict__ v_out, Grid g,
               ViscParams p) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  if (r >= g.rows || c >= g.cols) return;
  const size_t i = static_cast<size_t>(r) * g.cols + c;
  const bool v_wall = g.is_north && r == g.ny_l + 1;

  if (!interior(g, r, c)) {
    u_out[i] = u[i];
    v_out[i] = v_wall ? 0.0f : v[i];
    return;
  }
  u_out[i] = u[i] + p.dt * laplacian(u, g, p, r, c);
  v_out[i] = v_wall ? 0.0f : v[i] + p.dt * laplacian(v, g, p, r, c);
}

constexpr int BLOCK_X = 32;
constexpr int BLOCK_Y = 8;

dim3 grid_for(const Grid& g) {
  return dim3((g.cols + BLOCK_X - 1) / BLOCK_X,
              (g.rows + BLOCK_Y - 1) / BLOCK_Y);
}

}  // namespace

// -- plain C launchers (loaded with ctypes); each returns the launch's
// cudaError_t, 0 on success -----------------------------------------------

extern "C" int sw_main_launch(const float* h, const float* u, const float* v,
                              const float* dh, const float* du,
                              const float* dv, float* h_out, float* u_out,
                              float* v_out, float* dh_out, float* du_out,
                              float* dv_out, int rows, int cols, int ny_l,
                              int nx_l, int is_south, int is_north, int iy,
                              float dx, float dy, float grav, float cor_f,
                              float cor_beta, float dt, float ab_a,
                              float ab_b, int first_step, void* stream) {
  const Grid g{rows, cols, ny_l, nx_l, is_south, is_north};
  const MainParams p{dx, dy, grav, cor_f, cor_beta, dt, ab_a, ab_b,
                     iy, first_step};
  sw_main_kernel<<<grid_for(g), dim3(BLOCK_X, BLOCK_Y), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      h, u, v, dh, du, dv, h_out, u_out, v_out, dh_out, du_out, dv_out, g,
      p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sw_visc_launch(const float* u, const float* v, float* u_out,
                              float* v_out, int rows, int cols, int ny_l,
                              int nx_l, int is_south, int is_north, float dx,
                              float dy, float nu, float dt, void* stream) {
  const Grid g{rows, cols, ny_l, nx_l, is_south, is_north};
  const ViscParams p{dx, dy, nu, dt};
  sw_visc_kernel<<<grid_for(g), dim3(BLOCK_X, BLOCK_Y), 0,
                   static_cast<cudaStream_t>(stream)>>>(u, v, u_out, v_out,
                                                         g, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

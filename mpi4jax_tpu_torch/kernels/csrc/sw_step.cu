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
// writes six (12 x 4 B per cell: 312.1 MB at the 3600 x 1800 bench
// block, 0.0932 ms at the H100's 3.35 TB/s) for some 83 float operations
// per cell; sw_visc reads and writes two fields each.  Both are far
// below the H100's operations-per-byte balance point, so what matters
// is to move each field once and to keep the arithmetic out of the
// loads' way.
//
// What held sw_main's first form back: one thread per cell on 32 x 8
// blocks, each recomputing from global memory the ring-1 intermediates
// it needs (4 fe, 4 fn, 3 q, 3 ke): 15 IEEE divisions a cell where 9
// do, about 23 loads a cell where 6 do, and a wall-row branch in every
// intermediate.  Its issue time and its memory time added up: 0.1830 ms
// a launch, 1.71 TB/s (H100 80GB HBM3, 700 W).
//
// Design of sw_main (column streams, as sw_visc below): each warp owns 32
// consecutive columns and walks a 4-row strip down them after one prologue
// step at the row above.  Lane 0 sits one column west of the 30 columns the
// warp updates and lane 31 one column east.  At row r a lane computes fe(r+1),
// fn(r), q(r) and ke(r+1) once, from the rows r and r+1 of its column, and
// carries fe(r), fn(r-1), q(r-1) and ke(r) from the previous step; the
// western neighbours (fe, q, u) come from lane - 1 and the eastern ones (fn,
// ke, h, v) from lane + 1 by shuffle: 9 divisions, 6 loads and 6 stores a
// cell.  The next row's fields are in flight while a row is computed, in a
// two-row ring in shared memory that each lane fills for its own column by
// cp.async. Every value is the same expression of the same operands, in the
// same association, as in the plain version, so the result is bit for bit the
// same.  The forms tried, each bit for bit the same and timed in turns as an
// edited copy of this file by chip_smoke.py --sw-forms, per launch on the
// bench block (H100 80GB HBM3, 700 W): this one 0.1333 ms (2.34 TB/s); the
// next row loaded into registers instead 0.1394, no row in flight 0.1363
// (registers) and 0.1401 (ring), two rows 0.1446 and 0.1344; 31 columns a
// warp, lane 31 loading its eastern column itself, 0.1416; strips of 8, 16
// and 32 rows 0.1476, 0.1620 and 0.1837.  Taller strips recompute the prologue
// less often but run slower (likely: the rows that the blocks in flight touch
// outgrow the 50 MB L2; not measured).  A copy of the same fields in the same
// pattern with the arithmetic removed runs no faster than the whole kernel,
// so the access pattern, not the arithmetic, now sets its time (PERF.md §6).
//
// Design of sw_visc (column streams): each warp owns 32 consecutive
// columns and walks 8 rows down them, one row per step, both fields at
// once.  Lane 0 sits one column west of the 31 columns the warp updates
// and only supplies their first western flux.  Per row a lane computes
// the eastern flux gx of its cell from its eastern neighbour (the next
// lane's value, by shuffle; lane 31 loads its own) and the northern
// flux gy from the next row; the western flux comes from the previous
// lane by shuffle and the southern one from the previous row, so every
// flux is computed once rather than by both cells that share it: a field
// costs 4 IEEE divisions a cell rather than 6.  Each cell is loaded once
// by its own lane; only the column east of a warp (by lane 31) and the
// rows just outside an 8-row strip are loaded again, from cache.  Every
// value is the same expression of the same operands as in the plain
// version, so the result is bit for bit the same.  A tiled form that
// staged 128 x 16 cells and a ring in shared memory and computed the
// fluxes into it ran slower on the card than one thread per cell, and
// taller strips ran slower than 8 rows (PERF.md §6).
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

// -- sw_main --------------------------------------------------------------

constexpr int MAIN_WARPS = 4;  // warps of a block, side by side in x
constexpr int MAIN_COLS = 30;  // columns a warp updates (lanes 1..MAIN_COLS)
constexpr int MAIN_TY = 4;     // rows a block walks down

// ---- PTX helpers: the kernel's only inline assembly ----

// 4-byte asynchronous copy global -> shared; bytes is 4, or 0 to
// zero-fill the destination without reading the source
__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- end of the PTX helpers ----

// One row of a lane's column as the stream carries it: h, u, v and the
// tendencies (zero on the first step and on rows the strip does not
// update).
struct Row {
  float h, u, v, dh, du, dv;
};

// mass flux 0.5 (h0 + h1) w: fe from h(r, c), h(r, c+1), u(r, c); fn from
// h(r, c), h(r+1, c), v(r, c)
__device__ __forceinline__ float flux(float h0, float h1, float w) {
  return 0.5f * (h0 + h1) * w;
}

// kinetic energy from u(r, c), u(r, c-1), v(r, c), v(r-1, c)
__device__ __forceinline__ float kinetic(float u0, float uw, float v0,
                                         float vs) {
  return 0.5f * (0.5f * (u0 * u0 + uw * uw) + 0.5f * (v0 * v0 + vs * vs));
}

__global__ void __launch_bounds__(32 * MAIN_WARPS)
sw_main_kernel(const float* __restrict__ h, const float* __restrict__ u,
               const float* __restrict__ v, const float* __restrict__ dh,
               const float* __restrict__ du, const float* __restrict__ dv,
               float* __restrict__ h_out, float* __restrict__ u_out,
               float* __restrict__ v_out, float* __restrict__ dh_out,
               float* __restrict__ du_out, float* __restrict__ dv_out,
               Grid g, MainParams p) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // this lane's column: lane 0 sits one column west of the warp's
  // MAIN_COLS columns, lane 31 one column east
  const int base = (blockIdx.x * MAIN_WARPS + warp) * MAIN_COLS;
  if (base >= g.cols) return;  // the whole warp: no column to update
  const int c = base - 1 + lane;
  const bool updates = lane >= 1 && lane <= MAIN_COLS && c < g.cols;
  const int r0 = blockIdx.y * MAIN_TY;
  const int r1 = min(r0 + MAIN_TY, g.rows);

  // The rows of the stream, r0 - 1 to r1, each copied by cp.async into a
  // ring of two rows in shared memory one step before the step that
  // takes it.  Each lane copies and reads only its own ring slots, so
  // waiting for its own copies is all the synchronisation needed.
  __shared__ float ring[2][6][32 * MAIN_WARPS];
  const int t = threadIdx.x;
  auto stage = [&](int k) {  // row k's fields, tendencies where updated
    const int s = (k + 2) % 2;
    const bool in = c >= 0 && c < g.cols && k >= 0 && k < g.rows;
    const size_t i = in ? static_cast<size_t>(k) * g.cols + c : 0;
    const bool tend = in && !p.first_step && k >= r0 && k < r1;
    cp_async_4(&ring[s][0][t], h + i, in ? 4 : 0);
    cp_async_4(&ring[s][1][t], u + i, in ? 4 : 0);
    cp_async_4(&ring[s][2][t], v + i, in ? 4 : 0);
    cp_async_4(&ring[s][3][t], dh + i, tend ? 4 : 0);
    cp_async_4(&ring[s][4][t], du + i, tend ? 4 : 0);
    cp_async_4(&ring[s][5][t], dv + i, tend ? 4 : 0);
  };
  // row k, once its copies have landed, with row k + 1 put in flight (an
  // empty group past the strip keeps the count of groups in flight)
  auto take = [&](int k) {
    if (k + 1 <= r1) stage(k + 1);
    cp_async_commit();
    cp_async_wait<1>();
    const int s = (k + 2) % 2;
    return Row{ring[s][0][t], ring[s][1][t], ring[s][2][t],
               ring[s][3][t], ring[s][4][t], ring[s][5][t]};
  };
  stage(r0 - 1);
  cp_async_commit();

  // The step at row r (cur: row r, nxt: row r+1) computes fe(r+1),
  // fn(r), q(r) and ke(r+1) once and takes row r's others from the
  // previous step (fe(r), fn(r-1), q(r-1), ke(r)); the neighbours come
  // from lane - 1 (fe, q, u: west) and lane + 1 (fn, ke, h, v: east) by
  // shuffle.  The step at r0 - 1 is the strip's prologue: it computes
  // the intermediates row r0 takes from it and updates nothing.
  Row cur = take(r0 - 1);
  float hc_e = __shfl_down_sync(kAll, cur.h, 1);  // h(r, c+1)
  float fe_c = 0.0f, fe_w = 0.0f;   // fe(r, c), fe(r, c-1)
  float fn_s = 0.0f, fn_se = 0.0f;  // fn(r-1, c), fn(r-1, c+1)
  float q_s = 0.0f;                 // q(r-1, c)
  float ke_c = 0.0f, ke_e = 0.0f;   // ke(r, c), ke(r, c+1)
  for (int r = r0 - 1; r < r1; ++r) {
    const Row nxt = take(r + 1);
    // every lane shuffles: a lane that sat one out would hang the warp
    const float hn_e = __shfl_down_sync(kAll, nxt.h, 1);
    const float vc_e = __shfl_down_sync(kAll, cur.v, 1);
    const float un_w = __shfl_up_sync(kAll, nxt.u, 1);

    // ring-1 rows beyond a wall hold zero in every intermediate; the
    // northern flux is also zero on the last interior row
    const bool wall_c = wall_row(g, r), wall_n = wall_row(g, r + 1);
    const bool fn_zero = wall_c || (g.is_north && r == g.ny_l + 1);
    const float fe_n = wall_n ? 0.0f : flux(nxt.h, hn_e, nxt.u);
    const float fn_c = fn_zero ? 0.0f : flux(cur.h, nxt.h, cur.v);
    // Coriolis f + beta * y at the row's global y coordinate
    const float yy = ((static_cast<float>(r) - 2.0f) +
                      static_cast<float>(p.iy * g.ny_l)) *
                     p.dy;
    const float cor = p.cor_f + yy * p.cor_beta;
    const float rel_vort = (vc_e - cur.v) / p.dx - (nxt.u - cur.u) / p.dy;
    const float depth = 0.25f * (cur.h + hc_e + nxt.h + hn_e);
    const float q_c = wall_c ? 0.0f : (cor + rel_vort) / depth;
    const float ke_n = wall_n ? 0.0f : kinetic(nxt.u, un_w, nxt.v, cur.v);

    const float fe_nw = __shfl_up_sync(kAll, fe_n, 1);
    const float q_w = __shfl_up_sync(kAll, q_c, 1);
    const float fn_e = __shfl_down_sync(kAll, fn_c, 1);
    const float ke_ne = __shfl_down_sync(kAll, ke_n, 1);

    if (r >= r0 && updates) {
      const size_t i = static_cast<size_t>(r) * g.cols + c;
      // v = 0 on the northern wall row (the last interior row), ghost
      // columns included
      const bool v_wall = g.is_north && r == g.ny_l + 1;
      if (!interior(g, r, c)) {
        h_out[i] = cur.h;
        u_out[i] = cur.u;
        v_out[i] = v_wall ? 0.0f : cur.v;
        dh_out[i] = 0.0f;
        du_out[i] = 0.0f;
        dv_out[i] = 0.0f;
      } else {
        const float dh_new = -(fe_c - fe_w) / p.dx - (fn_c - fn_s) / p.dy;
        float du_new = -p.grav * (hc_e - cur.h) / p.dx +
                       0.5f * (q_c * 0.5f * (fn_c + fn_e) +
                               q_s * 0.5f * (fn_s + fn_se));
        float dv_new = -p.grav * (nxt.h - cur.h) / p.dy -
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
          h_inc = p.dt * (p.ab_a * dh_new + p.ab_b * cur.dh);
          u_inc = p.dt * (p.ab_a * du_new + p.ab_b * cur.du);
          v_inc = p.dt * (p.ab_a * dv_new + p.ab_b * cur.dv);
        }
        h_out[i] = cur.h + h_inc;
        u_out[i] = cur.u + u_inc;
        v_out[i] = v_wall ? 0.0f : cur.v + v_inc;
        dh_out[i] = dh_new;
        du_out[i] = du_new;
        dv_out[i] = dv_new;
      }
    }

    // row r + 1 takes over this step's values
    cur = nxt;
    hc_e = hn_e;
    fe_c = fe_n;
    fe_w = fe_nw;
    q_s = q_c;
    fn_s = fn_c;
    fn_se = fn_e;
    ke_c = ke_n;
    ke_e = ke_ne;
  }
}

// -- sw_visc --------------------------------------------------------------

constexpr int VISC_WARPS = 4;  // warps of a block, side by side in x
constexpr int VISC_COLS = 31;  // columns a warp updates (lane 0 feeds them)
constexpr int VISC_TY = 8;     // rows a block walks down

__global__ void __launch_bounds__(32 * VISC_WARPS)
sw_visc_kernel(const float* __restrict__ u, const float* __restrict__ v,
               float* __restrict__ u_out, float* __restrict__ v_out, Grid g,
               ViscParams p) {
  constexpr unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  // this lane's column: lane 0 sits one column west of the warp's
  // VISC_COLS columns and only supplies their first western flux
  const int c = (blockIdx.x * VISC_WARPS + warp) * VISC_COLS - 1 + lane;
  const int r0 = blockIdx.y * VISC_TY;
  const int r1 = min(r0 + VISC_TY, g.rows);
  const bool col_in = c >= 0 && c < g.cols;
  const bool east_in = c + 1 < g.cols;
  auto load = [&](const float* w, int r) {
    return col_in && r >= 0 && r < g.rows ? at(w, g, r, c) : 0.0f;
  };
  // viscous fluxes, zero beyond the walls
  auto flux = [&](int r, float w0, float w1, float d) {
    return wall_row(g, r) ? 0.0f : p.nu * (w1 - w0) / d;
  };

  // the stream of each field: this row's value and the southern flux
  float uc = load(u, r0), vc = load(v, r0);
  float gy_us = flux(r0 - 1, load(u, r0 - 1), uc, p.dy);
  float gy_vs = flux(r0 - 1, load(v, r0 - 1), vc, p.dy);
  for (int r = r0; r < r1; ++r) {
    const float un = load(u, r + 1), vn = load(v, r + 1);
    // the eastern neighbours from the next lane; lane 31 reads its own
    float ue = __shfl_down_sync(kAll, uc, 1);
    float ve = __shfl_down_sync(kAll, vc, 1);
    if (lane == 31) {
      ue = col_in && east_in ? at(u, g, r, c + 1) : 0.0f;
      ve = col_in && east_in ? at(v, g, r, c + 1) : 0.0f;
    }
    const float gx_u = flux(r, uc, ue, p.dx), gx_v = flux(r, vc, ve, p.dx);
    const float gx_uw = __shfl_up_sync(kAll, gx_u, 1);
    const float gx_vw = __shfl_up_sync(kAll, gx_v, 1);
    const float gy_u = flux(r, uc, un, p.dy), gy_v = flux(r, vc, vn, p.dy);
    if (lane > 0 && col_in) {
      float uo = uc, vo = vc;
      if (interior(g, r, c)) {
        uo = uc + p.dt * ((gx_u - gx_uw) / p.dx + (gy_u - gy_us) / p.dy);
        vo = vc + p.dt * ((gx_v - gx_vw) / p.dx + (gy_v - gy_vs) / p.dy);
      }
      // v = 0 on the northern wall row (the last interior row), ghost
      // columns included
      if (g.is_north && r == g.ny_l + 1) vo = 0.0f;
      const size_t i = static_cast<size_t>(r) * g.cols + c;
      u_out[i] = uo;
      v_out[i] = vo;
    }
    uc = un;
    vc = vn;
    gy_us = gy_u;
    gy_vs = gy_v;
  }
}

dim3 main_grid_for(const Grid& g) {
  constexpr int kCols = MAIN_WARPS * MAIN_COLS;  // columns of a block
  return dim3((g.cols + kCols - 1) / kCols,
              (g.rows + MAIN_TY - 1) / MAIN_TY);
}

dim3 visc_grid_for(const Grid& g) {
  constexpr int kCols = VISC_WARPS * VISC_COLS;  // columns of a block
  return dim3((g.cols + kCols - 1) / kCols, (g.rows + VISC_TY - 1) / VISC_TY);
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
  sw_main_kernel<<<main_grid_for(g), dim3(32 * MAIN_WARPS), 0,
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
  sw_visc_kernel<<<visc_grid_for(g), dim3(32 * VISC_WARPS), 0,
                   static_cast<cudaStream_t>(stream)>>>(u, v, u_out, v_out,
                                                         g, p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sw_step_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

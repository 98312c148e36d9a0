// prep_splats — the render's per-(view, point) set-up: EWA set-up,
// projection and shading forward (prep_fwd_kernel), and the gradient of the
// projection and the shading backward (prep_bwd_kernel).
//
// Replaces no Pallas kernel: in dss_tpu this work is XLA's fusion of
// dss_tpu/render/ewa.py:prepare_splats and render/lighting.py:shade_points.
// In the port it was ~380 stock-torch kernels per train step (forward and
// backward, each a graph node of a few µs on (V, P) rows), where its bytes
// need ~2 µs: (V, P) rows of ~30 floats.
//
// Contract: the forward is render/prep.py:prep_composite, the backward
// render/prep.py:prep_bwd_plain (the composite's gradient in closed form),
// whose operations this file repeats one for one, in their order (the
// library builds with -fmad=false; the fused multiply-adds are explicit
// fmaf).  The forward rounds as the composite rounds on this card: its
// Jacobian Mk is two products and their sum an entry (compute_wjk writes
// it out), its other matmuls and einsums are cuBLAS FMA chains from +0 in
// index order, its 3-term shading einsums fma(a1, b1, a0·b0) + a2·b2, its
// vector norms √((x² + z²) + y²), and with one view the Jacobian's w, a
// GEMM of one column there, fma(x1, m1, x0·m0) + (x2·m2 + m3).  cuBLAS
// picks these orders by shape; check_prep in chip_smoke.py holds them at
// every cell's.
// So the forward's outputs equal the composite's bit for bit, and no
// splat's accept test or depth order moves (the plain float32 reference
// that decides the benchmark's `correct` runs that composite).
//
// What bounds it on the H100: launch latency and the per-thread chain.
// Bytes: the forward reads 40 B and writes 60 B per (view, point), the
// backward reads 24 B per (view, point) and 36 B per point: ~4 MB at the
// flagship's V 8, P 5000 (~1.3 µs at 3.35 TB/s).  Operations: ~250 per
// (view, point) forward, ~400 backward with 3 lights (~0.3 µs at
// 67 TFLOP/s).
//
// Design: the forward runs one thread per (view, point), a block's 256
// points in one view, whose constants (the full projection, R, T, znear,
// zfar, the camera centre, the summed ambient and the L lights) the block
// stages in shared memory once.  The backward runs BWD_LANES threads per
// point: lane j computes the point's gradients of views j, j + BWD_LANES,
// ... (a chunk's constants staged in shared memory), and lane 0 adds the
// views' parts in view order, in registers: no atomics, so its sums are
// the same in every run, and they are those of one thread walking the
// views in order (the plain version's).  A warp is 32 points of one view,
// whose cotangent rows are 384 contiguous bytes.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float DENOM_EPS = 1e-17f;  // mathutil.DENOM_EPS
constexpr float SQRT_EPS = 1e-17f;   // mathutil.SQRT_EPS
constexpr float SHADE_EPS = 1e-6f;   // prep.SHADE_EPS
constexpr float FRAME_EPS = 1e-12f;  // mathutil.tangent_frame's
constexpr float CLIP_EPS = 1e-12f;   // prep.CLIP_EPS
// π² rounded to float32, as the composite's scalar
constexpr float PI2 = static_cast<float>(9.869604401089358);
enum { SHADE_COPY = 0, SHADE_POINT, SHADE_DIRECTIONAL, SHADE_NONE };

// A view's record in shared memory: the full projection M (row-major 4×4),
// R (row-major 3×3), T, znear, zfar, the camera centre, the ambient colours
// summed (over their own La entries), then per light its diffuse and
// specular colours and its location (point) or unit direction
// (directional).
enum { M0 = 0, R0 = 16, T0 = 25, ZN = 28, ZF = 29, C0 = 30, AMB = 33,
       VIEW = 36, LIGHT = 9 };
constexpr int MAX_LIGHTS = 64;  // ops/kernels.py PREP_MAX_LIGHTS
constexpr int FWD_THREADS = 256;
constexpr int BWD_POINTS = 32, BWD_LANES = 8;
constexpr int BWD_THREADS = BWD_POINTS * BWD_LANES;

struct Views {
  const float *proj, *R, *T, *znear, *zfar;  // (V,4,4) (V,3,3) (V,3) (V,)
  const float* amb;                          // (V, La, 3) or null
  const float *dif, *spec, *where;           // (V, L, 3) or null
  int L, La, shade;
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // torch.clamp: NaN stays NaN
}

__device__ __forceinline__ float eps_denom(float x) {
  return (x < 0.0f ? -1.0f : 1.0f) * clamp_min(fabsf(x), DENOM_EPS);
}

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a != a || b != b) ? CUDART_NAN_F : (a > b ? a : b);
}

// the gradient factor of torch.maximum(x, 0) in x
__device__ __forceinline__ float half_grad(float x) {
  return x == 0.0f ? 0.5f : (x < 0.0f ? 0.0f : 1.0f);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2];
}

// the shading's 3-term einsums: fma(a1, b1, a0·b0) + a2·b2
__device__ __forceinline__ float dot_pi(const float* a, const float* b) {
  return fmaf(a[1], b[1], a[0] * b[0]) + a[2] * b[2];
}

// Σ_i x_i · m[i][j] (row length n) as a GEMM: an FMA chain from +0
__device__ __forceinline__ float row_dot(const float* x, const float* m, int n,
                                         int j) {
  return fmaf(x[2], m[2 * n + j], fmaf(x[1], m[n + j], fmaf(x[0], m[j], 0.0f)));
}

__device__ __forceinline__ float view_depth(const float* x, const float* s) {
  return row_dot(x, s + R0, 3, 2) + s[T0 + 2];
}

__device__ __forceinline__ float hom(const float* x, const float* s, int j) {
  return row_dot(x, s + M0, 4, j) + s[M0 + 12 + j];
}

// hom as cuBLAS sums a GEMM of one column (compute_wjk's
// `hom @ m44[:, :, 3].T` with one view): two FMA pairs, then their sum
__device__ __forceinline__ float hom_gemv(const float* x, const float* s,
                                          int j) {
  const float* m = s + M0;
  return fmaf(x[1], m[4 + j], x[0] * m[j]) + (x[2] * m[8 + j] + m[12 + j]);
}

// out = u / max(|u|, eps); returns |u| = √((u0² + u2²) + u1²)
__device__ __forceinline__ float normalize(const float* u, float eps,
                                           float* out) {
  const float n = sqrtf((u[0] * u[0] + u[2] * u[2]) + u[1] * u[1]);
  const float c = clamp_min(n, eps);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = u[i] / c;
  return n;
}

// out = the gradient in u of u / max(|u|, eps) under dy (|u| = n)
__device__ __forceinline__ void normalize_bwd(const float* u, float n,
                                              const float* dy, float eps,
                                              float* out) {
  const float c = clamp_min(n, eps);
  const float gn = n >= eps ? -dot3(dy, u) / (c * c) : 0.0f;
  const float ratio = n >= eps ? gn / n : 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = dy[i] / c + u[i] * ratio;
}

// Stage the records of views [v0, v0 + n) in shared memory, one every
// VIEW + LIGHT·L floats (every thread of the block calls it; it opens with
// a barrier, so what the block read of the previous records is done, and
// ends with one).
__device__ void load_views(float* s, const Views& w, int v0, int n) {
  __syncthreads();
  const int L = w.L, raw = ZF + 1 + LIGHT * L, rec = VIEW + LIGHT * L;
  for (int t = threadIdx.x; t < n * raw; t += blockDim.x) {
    const int j = t / raw, i = t % raw, v = v0 + j;
    float* sv = s + j * rec;
    if (i < R0) {
      sv[i] = w.proj[v * 16 + i];
    } else if (i < T0) {
      sv[i] = w.R[v * 9 + i - R0];
    } else if (i < ZN) {
      sv[i] = w.T[v * 3 + i - T0];
    } else if (i == ZN) {
      sv[i] = w.znear[v];
    } else if (i == ZF) {
      sv[i] = w.zfar[v];
    } else {
      const int k = (i - ZF - 1) % LIGHT, l = (i - ZF - 1) / LIGHT;
      const float* src = k < 3 ? w.dif : (k < 6 ? w.spec : w.where);
      sv[VIEW + i - ZF - 1] = src[((size_t)v * L + l) * 3 + k % 3];
    }
  }
  __syncthreads();
  if (threadIdx.x < n) {
    const int v = v0 + threadIdx.x;
    float* sv = s + threadIdx.x * rec;
    const float* R = sv + R0;
    const float* T = sv + T0;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      sv[C0 + i] = -fmaf(T[2], R[i * 3 + 2],
                         fmaf(T[1], R[i * 3 + 1], fmaf(T[0], R[i * 3], 0.0f)));
    float am[3] = {0.0f, 0.0f, 0.0f};
    for (int l = 0; l < w.La; ++l) {
      const float* a = w.amb + ((size_t)v * w.La + l) * 3;
#pragma unroll
      for (int i = 0; i < 3; ++i) am[i] = am[i] + a[i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) sv[AMB + i] = am[i];
    for (int l = 0; l < L && w.shade == SHADE_DIRECTIONAL; ++l) {
      float* d = sv + VIEW + LIGHT * l + 6;
      float u[3] = {d[0], d[1], d[2]};
      normalize(u, SHADE_EPS, d);
    }
  }
  __syncthreads();
}

// Light l's unit direction toward it; for a point light also u = location
// − p and |u|.
__device__ __forceinline__ void light_dir(const float* s, int shade, int l,
                                          const float* p, float* d, float* u,
                                          float* ulen) {
  const float* wl = s + VIEW + LIGHT * l + 6;
  if (shade == SHADE_POINT) {
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = wl[i] - p[i];
    *ulen = normalize(u, SHADE_EPS, d);
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) d[i] = wl[i];
  }
}

struct FwdArgs {
  const float *points, *normals, *colors;
  const bool* mask;
  Views views;
  const float *h, *vrk, *sk;
  int h_stride, vrk_s0, vrk_s1, vrk_s2, sk_s0, sk_s1, sk_s2;
  float *shaded, *screen, *ell, *cut, *rad, *scl;
  bool* rmask;
  int P, backface, gemv_w;
  float lam, lam_sq, cutoff, shininess;
};

__global__ void __launch_bounds__(FWD_THREADS)
    prep_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ float s[];
  const int v = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  load_views(s, a.views, v, 1);
  if (p >= a.P) return;
  const float* R = s + R0;
  const float* M = s + M0;
  float pt[3], nr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    pt[i] = a.points[(size_t)p * 3 + i];
    nr[i] = a.normals[(size_t)p * 3 + i];
  }
  const float z = view_depth(pt, s);
  const bool depth_ok = z >= s[ZN] && z <= s[ZF];
  bool rm = a.mask[p] && depth_ok;
  if (a.backface) rm = rm && row_dot(nr, R, 3, 2) < 0.0f;
  // depth-culled rows project the dummy camera centre + view axis
  float sp[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    sp[i] = depth_ok ? pt[i] : s[C0 + i] + R[i * 3 + 2];
  const size_t o = (size_t)v * a.P + p;
  const float w = eps_denom(hom(sp, s, 3));
  a.screen[o * 3] = hom(sp, s, 0) / w;
  a.screen[o * 3 + 1] = hom(sp, s, 1) / w;
  a.screen[o * 3 + 2] = view_depth(sp, s);

  // the Jacobian Mk (3 × 2) of the projection at the point itself
  const float hx = hom(pt, s, 0), hy = hom(pt, s, 1);
  const float hw = a.gemv_w ? hom_gemv(pt, s, 3) : hom(pt, s, 3);
  const float inv_t = 1.0f / eps_denom(hw);
  const float inv_t2 = 1.0f / eps_denom(hw * hw);
  const float jx = -hx * inv_t2, jy = -hy * inv_t2;
  // W[:3] @ Jk over the 4 × 2 Jacobian [[1/t, 0], [0, 1/t], [0, 0],
  // [jx, jy]]: two products and their sum an entry, as compute_wjk writes it
  float mk[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float* Mi = M + i * 4;
    mk[i][0] = Mi[0] * inv_t + Mi[3] * jx;
    mk[i][1] = Mi[1] * inv_t + Mi[3] * jy;
  }
  float sk[2][3], vrk[3][3];
  if (a.h) {
    // mathutil.tangent_frame (Duff et al.)
    float nn[3];
    normalize(nr, FRAME_EPS, nn);
    const float x = nn[0], y = nn[1], zz = nn[2];
    const float sign = zz >= 0.0f ? 1.0f : -1.0f;
    const float ta = -1.0f / ((sign + zz) + (zz >= 0.0f ? FRAME_EPS : -FRAME_EPS));
    const float tb = (x * y) * ta;
    sk[0][0] = 1.0f + ((sign * x) * x) * ta;
    sk[0][1] = sign * tb;
    sk[0][2] = -(sign * x);
    sk[1][0] = tb;
    sk[1][1] = sign + (y * y) * ta;
    sk[1][2] = -y;
    const float hh = a.h[(size_t)p * a.h_stride];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        vrk[i][j] = hh * fmaf(sk[1][i], sk[1][j], fmaf(sk[0][i], sk[0][j], 0.0f));
  } else {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        vrk[i][j] = a.vrk[(size_t)p * a.vrk_s0 + i * a.vrk_s1 + j * a.vrk_s2];
#pragma unroll
      for (int k = 0; k < 2; ++k)
        sk[k][i] = a.sk[(size_t)p * a.sk_s0 + k * a.sk_s1 + i * a.sk_s2];
    }
  }
  // GV = Mkᵀ (Vrk Mk) + λI; det(Sk Mk)
  float av[3][2], gv[2][2], skmk[2][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      av[i][k] = fmaf(vrk[i][2], mk[2][k],
                      fmaf(vrk[i][1], mk[1][k], fmaf(vrk[i][0], mk[0][k], 0.0f)));
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      gv[k][m] = fmaf(mk[2][k], av[2][m],
                      fmaf(mk[1][k], av[1][m], fmaf(mk[0][k], av[0][m], 0.0f)));
      skmk[k][m] = fmaf(sk[k][2], mk[2][m],
                        fmaf(sk[k][1], mk[1][m], fmaf(sk[k][0], mk[0][m], 0.0f)));
    }
  // + λI: λ on the diagonal, +0 off it
  gv[0][0] = gv[0][0] + a.lam;
  gv[0][1] = gv[0][1] + 0.0f;
  gv[1][0] = gv[1][0] + 0.0f;
  gv[1][1] = gv[1][1] + a.lam;
  const float det_mk = skmk[0][0] * skmk[1][1] - skmk[0][1] * skmk[1][0];
  const float det_gv = tmax(gv[0][0] * gv[1][1] - gv[0][1] * gv[1][0],
                            a.lam * (gv[0][0] + gv[1][1]) - a.lam_sq);
  const float ca = gv[1][1] / det_gv;
  const float cb = -(gv[0][1] + gv[1][0]) / det_gv;
  const float cc = gv[0][0] / det_gv;
  const float denom = eps_denom((4.0f * ca) * cc - cb * cb);
  const float rx = sqrtf(clamp_min(((4.0f * cc) * a.cutoff) / denom, SQRT_EPS));
  const float ry = sqrtf(clamp_min(((4.0f * ca) * a.cutoff) / denom, SQRT_EPS));
  const float keep = rm ? 1.0f : 0.0f;
  a.ell[o * 3] = ca;
  a.ell[o * 3 + 1] = cb;
  a.ell[o * 3 + 2] = cc;
  a.cut[o] = rm ? a.cutoff : -CUDART_INF_F;
  a.rad[o * 2] = rx * keep;
  a.rad[o * 2 + 1] = ry * keep;
  a.scl[o] = fabsf(det_mk) /
             eps_denom(sqrtf(clamp_min((det_gv * 4.0f) * PI2, SQRT_EPS)));
  a.rmask[o] = rm;

  const int shade = a.views.shade;
  if (shade == SHADE_NONE) return;
  float rgb[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) rgb[i] = a.colors[(size_t)p * 3 + i];
  if (shade == SHADE_COPY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) a.shaded[o * 3 + i] = rgb[i];
    return;
  }
  float nn[3], uv[3], vd[3];
  normalize(nr, SHADE_EPS, nn);
#pragma unroll
  for (int i = 0; i < 3; ++i) uv[i] = s[C0 + i] - pt[i];
  normalize(uv, SHADE_EPS, vd);
  float dif[3] = {0.0f, 0.0f, 0.0f}, spc[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < a.views.L; ++l) {
    float d[3], u[3], ulen;
    light_dir(s, shade, l, pt, d, u, &ulen);
    const float cs = dot_pi(nn, d);
    const float angle = tmax(cs, 0.0f);
    float r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = -d[i] + (2.0f * cs) * nn[i];
    const float alpha = tmax(dot_pi(vd, r), 0.0f) * (cs > 0.0f ? 1.0f : 0.0f);
    const float pw = powf(alpha, a.shininess);
    const float* lc = s + VIEW + LIGHT * l;
    // the einsums over the lights: FMA chains from +0
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dif[i] = fmaf(lc[i], angle, dif[i]);
      spc[i] = fmaf(lc[3 + i], pw, spc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
    a.shaded[o * 3 + i] = rgb[i] * (s[AMB + i] + dif[i]) + spc[i];
}

struct BwdArgs {
  const float *points, *normals, *colors;
  Views views;
  const float *g_shaded, *g_screen;  // (V, P, 3) or null (zero)
  float *d_points, *d_normals, *d_colors;  // (P, 3) or null (not wanted)
  int V, P;
  float shininess, clip;
};

// One view's part of a point's gradients, from the view's record sv:
// out[0..2] the projection's (in the point), out[3..5] the shading's (in
// the point), out[6..8] in the shading's unit normal, out[9..11] in the
// colour.  Only the parts that the cotangents and the mode give are
// written.
__device__ void view_grads(const float* sv, const BwdArgs& a, int v, int p,
                           const float* pt, const float* nn, const float* rgb,
                           float* out) {
  const float* R = sv + R0;
  const float* M = sv + M0;
  const size_t o = (size_t)v * a.P + p;
  const int shade = a.views.shade;
  if (a.g_screen) {
    float g[3] = {a.g_screen[o * 3], a.g_screen[o * 3 + 1],
                  a.g_screen[o * 3 + 2]};
    if (a.clip > 0.0f) {
      const float gn = sqrtf(dot3(g, g));
      // torch.clamp(gn, 0, clip): NaN stays NaN
      const float lo = gn < 0.0f ? 0.0f : gn;
      const float scale = (lo > a.clip ? a.clip : lo) / clamp_min(gn, CLIP_EPS);
#pragma unroll
      for (int i = 0; i < 3; ++i) g[i] = g[i] * scale;
    }
    const float z = view_depth(pt, sv);
    // culled rows project a constant: no gradient
    if (z >= sv[ZN] && z <= sv[ZF]) {
      const float hx = hom(pt, sv, 0), hy = hom(pt, sv, 1), hw = hom(pt, sv, 3);
      const float w = eps_denom(hw);
      const float ww = w * w;
      const float dhx = g[0] / w, dhy = g[1] / w;
      const float dw = ((-g[0]) * hx) / ww + ((-g[1]) * hy) / ww;
      const float dhw = fabsf(hw) >= DENOM_EPS ? dw : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        out[i] = ((dhx * M[i * 4] + dhy * M[i * 4 + 1]) + dhw * M[i * 4 + 3]) +
                 g[2] * R[i * 3 + 2];
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) out[i] = 0.0f;
    }
  }
  if (a.g_shaded == nullptr || shade == SHADE_NONE) return;
  const float G[3] = {a.g_shaded[o * 3], a.g_shaded[o * 3 + 1],
                      a.g_shaded[o * 3 + 2]};
  if (shade == SHADE_COPY) {
#pragma unroll
    for (int i = 0; i < 3; ++i) out[9 + i] = G[i];
    return;
  }
  const int L = a.views.L;
  float uv[3], vd[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) uv[i] = sv[C0 + i] - pt[i];
  const float vlen = normalize(uv, SHADE_EPS, vd);
  // pass 1: the diffuse sum, for the colours' gradient
  float dif[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    float d[3], u[3], ulen;
    light_dir(sv, shade, l, pt, d, u, &ulen);
    const float angle = tmax(dot_pi(nn, d), 0.0f);
    const float* lc = sv + VIEW + LIGHT * l;
#pragma unroll
    for (int i = 0; i < 3; ++i) dif[i] = fmaf(lc[i], angle, dif[i]);
  }
  float sh_p[3] = {0.0f, 0.0f, 0.0f}, sh_nn[3] = {0.0f, 0.0f, 0.0f};
  float dvd[3] = {0.0f, 0.0f, 0.0f};
  // pass 2: per light, the specular and diffuse terms' gradients
  for (int l = 0; l < L; ++l) {
    float d[3], u[3], ulen;
    light_dir(sv, shade, l, pt, d, u, &ulen);
    const float cs = dot_pi(nn, d);
    const float t = 2.0f * cs;
    float r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) r[i] = -d[i] + t * nn[i];
    const float vr = dot_pi(vd, r);
    const float gate = cs > 0.0f ? 1.0f : 0.0f;
    const float alpha = tmax(vr, 0.0f) * gate;
    const float* lc = sv + VIEW + LIGHT * l;
    const float grgb[3] = {G[0] * rgb[0], G[1] * rgb[1], G[2] * rgb[2]};
    const float d_angle = dot3(grgb, lc);
    const float d_pw = dot3(G, lc + 3);
    const float d_alpha =
        a.shininess == 0.0f
            ? 0.0f
            : d_pw * (a.shininess * powf(alpha, a.shininess - 1.0f));
    const float d_vr = (d_alpha * gate) * half_grad(vr);
    float d_r[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      dvd[i] = dvd[i] + d_vr * r[i];
      d_r[i] = d_vr * vd[i];
    }
    const float d_cos = d_angle * half_grad(cs) + 2.0f * dot3(d_r, nn);
#pragma unroll
    for (int i = 0; i < 3; ++i) sh_nn[i] = sh_nn[i] + (t * d_r[i] + d_cos * d[i]);
    if (shade == SHADE_POINT) {
      float d_d[3], du[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) d_d[i] = -d_r[i] + d_cos * nn[i];
      normalize_bwd(u, ulen, d_d, SHADE_EPS, du);
#pragma unroll
      for (int i = 0; i < 3; ++i) sh_p[i] = sh_p[i] - du[i];
    }
  }
  float dv[3];
  normalize_bwd(uv, vlen, dvd, SHADE_EPS, dv);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[3 + i] = sh_p[i] - dv[i];
    out[6 + i] = sh_nn[i];
    out[9 + i] = G[i] * (sv[AMB + i] + dif[i]);
  }
}

// A block's BWD_LANES × BWD_POINTS threads: lane j of point i works on
// views j, j + BWD_LANES, ... (a warp is 32 points of one view, whose
// cotangent rows are contiguous); after each chunk of views lane 0 adds
// the chunk's parts in view order, so the sums are the same in every run.
__global__ void __launch_bounds__(BWD_THREADS)
    prep_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ float s[];
  const int rec = VIEW + LIGHT * a.views.L;
  float* part = s + BWD_LANES * rec;  // [BWD_LANES][BWD_POINTS][12]
  const int lane = threadIdx.x / BWD_POINTS, pi = threadIdx.x % BWD_POINTS;
  const int p = blockIdx.x * BWD_POINTS + pi;
  const bool active = p < a.P;
  const int shade = a.views.shade;
  const bool shading = a.g_shaded != nullptr && shade != SHADE_NONE;
  const bool lit = shading && shade != SHADE_COPY;
  float pt[3] = {0.0f, 0.0f, 0.0f}, nr[3] = {0.0f, 0.0f, 0.0f};
  float rgb[3] = {0.0f, 0.0f, 0.0f}, nn[3] = {0.0f, 0.0f, 0.0f};
  float nlen = 0.0f;
  if (active) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      pt[i] = a.points[(size_t)p * 3 + i];
      nr[i] = a.normals[(size_t)p * 3 + i];
      rgb[i] = a.colors[(size_t)p * 3 + i];
    }
    if (lit) nlen = normalize(nr, SHADE_EPS, nn);
  }
  float dp[3] = {0.0f, 0.0f, 0.0f}, dnn[3] = {0.0f, 0.0f, 0.0f};
  float drgb[3] = {0.0f, 0.0f, 0.0f};
  for (int v0 = 0; v0 < a.V; v0 += BWD_LANES) {
    const int n = min(BWD_LANES, a.V - v0);
    load_views(s, a.views, v0, n);
    if (active && lane < n)
      view_grads(s + lane * rec, a, v0 + lane, p, pt, nn, rgb,
                 part + (lane * BWD_POINTS + pi) * 12);
    __syncthreads();
    if (!active || lane != 0) continue;
    for (int j = 0; j < n; ++j) {
      const float* c = part + (j * BWD_POINTS + pi) * 12;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (a.g_screen) dp[i] = dp[i] + c[i];
        if (lit) {
          dp[i] = dp[i] + c[3 + i];
          dnn[i] = dnn[i] + c[6 + i];
        }
        if (shading) drgb[i] = drgb[i] + c[9 + i];
      }
    }
  }
  if (!active || lane != 0) return;
  if (a.d_points) {
#pragma unroll
    for (int i = 0; i < 3; ++i) a.d_points[(size_t)p * 3 + i] = dp[i];
  }
  if (a.d_normals) {
    float dn[3];
    normalize_bwd(nr, nlen, dnn, SHADE_EPS, dn);
#pragma unroll
    for (int i = 0; i < 3; ++i) a.d_normals[(size_t)p * 3 + i] = dn[i];
  }
  if (a.d_colors) {
#pragma unroll
    for (int i = 0; i < 3; ++i) a.d_colors[(size_t)p * 3 + i] = drgb[i];
  }
}

size_t view_bytes(int L) { return (size_t)(VIEW + LIGHT * L) * sizeof(float); }

}  // namespace

extern "C" int dss_prep_fwd(
    const float* points, const float* normals, const float* colors,
    const bool* mask, const float* proj, const float* R, const float* T,
    const float* znear, const float* zfar, const float* amb, const float* dif,
    const float* spec, const float* where, const float* h, const float* vrk,
    const float* sk, int h_stride, int vrk_s0, int vrk_s1, int vrk_s2,
    int sk_s0, int sk_s1, int sk_s2, float* shaded, float* screen, float* ell,
    float* cut, float* rad, float* scl, bool* rmask, int V, int P, int L,
    int La, int shade, int backface, float lam, float lam_sq, float cutoff,
    float shininess, cudaStream_t stream) {
  if (V <= 0 || P <= 0) return 0;
  if (L < 0 || L > MAX_LIGHTS || La < 0 || V > 65535)
    return (int)cudaErrorInvalidValue;
  FwdArgs a;
  a.points = points;
  a.normals = normals;
  a.colors = colors;
  a.mask = mask;
  a.views = Views{proj, R, T, znear, zfar, amb, dif, spec, where, L, La,
                  shade};
  a.h = h;
  a.vrk = vrk;
  a.sk = sk;
  a.h_stride = h_stride;
  a.vrk_s0 = vrk_s0;
  a.vrk_s1 = vrk_s1;
  a.vrk_s2 = vrk_s2;
  a.sk_s0 = sk_s0;
  a.sk_s1 = sk_s1;
  a.sk_s2 = sk_s2;
  a.shaded = shaded;
  a.screen = screen;
  a.ell = ell;
  a.cut = cut;
  a.rad = rad;
  a.scl = scl;
  a.rmask = rmask;
  a.P = P;
  a.backface = backface;
  a.gemv_w = V == 1;
  a.lam = lam;
  a.lam_sq = lam_sq;
  a.cutoff = cutoff;
  a.shininess = shininess;
  const dim3 grid((P + FWD_THREADS - 1) / FWD_THREADS, V);
  prep_fwd_kernel<<<grid, FWD_THREADS, view_bytes(L), stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int dss_prep_bwd(
    const float* points, const float* normals, const float* colors,
    const float* proj, const float* R, const float* T, const float* znear,
    const float* zfar, const float* amb, const float* dif, const float* spec,
    const float* where, const float* g_shaded, const float* g_screen,
    float* d_points, float* d_normals, float* d_colors, int V, int P, int L,
    int La, int shade, float shininess, float clip, cudaStream_t stream) {
  if (P <= 0) return 0;
  if (L < 0 || L > MAX_LIGHTS || La < 0) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.points = points;
  a.normals = normals;
  a.colors = colors;
  a.views = Views{proj, R, T, znear, zfar, amb, dif, spec, where, L, La,
                  shade};
  a.g_shaded = g_shaded;
  a.g_screen = g_screen;
  a.d_points = d_points;
  a.d_normals = d_normals;
  a.d_colors = d_colors;
  a.V = V;
  a.P = P;
  a.shininess = shininess;
  a.clip = clip;
  const size_t smem = BWD_LANES * view_bytes(L) +
                      (size_t)BWD_LANES * BWD_POINTS * 12 * sizeof(float);
  prep_bwd_kernel<<<(P + BWD_POINTS - 1) / BWD_POINTS, BWD_THREADS, smem,
                    stream>>>(a);
  return (int)cudaGetLastError();
}

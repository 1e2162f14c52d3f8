// Motion-only pose optimization (`Optimizer::PoseOptimization`,
// src/Optimizer.cc:239-451) as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pose_lm_kernel` and the epilogue of
// `pose_optimization_pallas` (orbslam_mapsave_tpu/optim/pose_opt_pallas.py),
// and computes what they compute: 4 rounds x 10 Levenberg-Marquardt
// iterations over M reprojection edges (mono and stereo-uR mixed), Huber
// weights on rounds 0-1, the 21 H + 6 g + cost sums of the normal system, a
// Jacobi-scaled damped 6x6 Cholesky with two refinement passes (a system
// that is not SPD gives dx = 0), a left SE3-exp update, strict-< acceptance
// with lambda x0.5 / x4 clipped to [1e-10, 1e6], inlier reclassification on
// raw chi2 between rounds, then the pose orthonormalized by three Newton
// polar steps, the inlier mask and the inlier count.
//
// What bounds it. An edge a pass reads needs 31 (mono) / 36 (stereo) FLOP
// of residual, an inlier 123 / 168 more for its Jacobians, H and g (44
// passes: ~13.5 MFLOP at M = 2048 on the seeded test problems), the bytes
// are 29 per edge in and 1 out, so on the whole card it would be FLOP-bound
// at a fifth of a microsecond. But one problem is one block on one SM
// (~27 us of FLOPs there at M = 2048), and
// the schedule is a chain of 40 dependent LM iterations, each waiting on a
// block reduction and a 6x6 solve whose own chain is bound by the latency
// of its IEEE divisions and square roots. The design cuts that chain:
//   - ONE edge pass per LM iteration. It evaluates, at the candidate pose,
//     H, g and the cost together. The cost decides acceptance against the
//     cost kept for the current pose; an accepted candidate's H and g are
//     the next system; a rejected step changes only lambda (pose, inliers
//     and robust flag are unchanged, so the kept system is still exact).
//     Each round starts with one pass at the current pose, which for
//     rounds >= 1 first reclassifies each edge from the same residual; the
//     last reclassification is the output pass. 4 x (1 + 10) reduction
//     passes instead of 80 + 4.
//   - The solve off the critical path when a step is rejected (most steps
//     are, once a round has converged): a rejected step's next system is
//     the kept one with lambda x4, known before the pass ends, so a
//     solver warp computes that candidate while 16 worker warps run the
//     pass. Only after an accepted step does the solve wait for the sums.
//   - A fixed-order block reduction with no serial tail: inside a worker
//     warp a butterfly reduce-scatter (31 shuffles for 28 sums, not
//     28 x 5), then lane q of the solver warp adds quantity q's 16 warp
//     partials in warp order and holds it, in a register, for the solve.
//     No atomics: reruns are bit-identical.
//   - The solve on the solver warp: lanes take the rows of the Jacobi
//     scaling, the entries of the scaled system, the rows of the refinement
//     residuals and the entries of the SE3 update. The Cholesky and
//     triangular-solve recurrences run in lock-step on every lane in the
//     serial order of `_solve6` (a shuffle per column step would lengthen a
//     chain bound by division latency).
//   - 512 worker threads (16 warps) to hide the FMA latency of the
//     28-accumulator edge loop; edges staged once in dynamic shared memory
//     (33 B per edge) read straight from the PoseObs tensors.
//   - One launch per call: the epilogue (orthonormalization, inlier mask,
//     exact integer inlier count) is in the kernel.
// One block per problem; a leading batch dimension B maps to B blocks.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (optim/pose_opt_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWorkers = 16;  // warps that run the edge passes
constexpr int kWorkerThreads = kWorkers * 32;
constexpr int kThreads = kWorkerThreads + 32;  // + the solver warp
constexpr int kRed = 28;  // 21 H upper triangle (row-major) + 6 g + cost
constexpr int kCost = 27;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr int kEdgeBytes = 2 * sizeof(float4) + 1;  // staged bytes per edge

__device__ __forceinline__ float sqrt_guard(float x) {
  return sqrtf(fmaxf(x, 1e-20f));
}

struct Cam {
  float fx, fy, cx, cy, bf;
};

// Per-edge residual terms at a pose (12 floats, row-major 3x4).
struct Edge {
  float px, py, pz, zi, eu, ev, eur, chi2;
  bool behind, stereo;
};

__device__ __forceinline__ Edge residual(const float (&p)[12], const Cam& c,
                                         const float4& a, const float4& o) {
  // a = (X, Y, Z, inv_sigma2), o = (u, v, uR, valid)
  Edge e;
  e.px = p[0] * a.x + p[1] * a.y + p[2] * a.z + p[3];
  e.py = p[4] * a.x + p[5] * a.y + p[6] * a.z + p[7];
  e.pz = p[8] * a.x + p[9] * a.y + p[10] * a.z + p[11];
  const float zsafe = fabsf(e.pz) < 1e-9f ? 1e-9f : e.pz;
  e.zi = 1.0f / zsafe;
  const float u_hat = c.fx * e.px * e.zi + c.cx;
  const float v_hat = c.fy * e.py * e.zi + c.cy;
  const float ur_hat = u_hat - c.bf * e.zi;
  e.stereo = o.z >= 0.0f;
  e.eu = o.x - u_hat;
  e.ev = o.y - v_hat;
  e.eur = e.stereo ? o.z - ur_hat : 0.0f;
  e.chi2 = (e.eu * e.eu + e.ev * e.ev + e.eur * e.eur) * a.w;
  e.behind = e.pz <= 0.0f;
  return e;
}

__device__ __forceinline__ bool within_gate(const Edge& r, bool valid) {
  return valid && r.chi2 <= (r.stereo ? kChi2Stereo : kChi2Mono) && !r.behind;
}

// Adds one edge's H (upper triangle), J^T e and cost terms to acc.
__device__ __forceinline__ void accumulate(const Edge& r, const Cam& cam,
                                           float is2, bool inl, bool robust,
                                           float (&acc)[kRed]) {
  const float delta2 = r.stereo ? kChi2Stereo : kChi2Mono;
  const float w_rob = (robust && r.chi2 > delta2)
                          ? sqrt_guard(delta2) / sqrt_guard(r.chi2)
                          : 1.0f;
  const float w = (inl && !r.behind) ? is2 * w_rob : 0.0f;
  const float zi2 = r.zi * r.zi;
  const float a = cam.fx * r.zi;
  const float c = -cam.fx * r.px * zi2;
  const float bb = cam.fy * r.zi;
  const float d = -cam.fy * r.py * zi2;
  // J rows over the tangent [v(3), w(3)] (pose_opt._normal_system)
  const float Ju[6] = {-a, 0.0f, -c, -(c * r.py), -(a * r.pz - c * r.px),
                       a * r.py};
  const float Jv[6] = {0.0f, -bb, -d, -(-bb * r.pz + d * r.py), d * r.px,
                       -bb * r.px};
  const float e3 = c + cam.bf * zi2;  // d(uR)/dPz
  float Jur[6] = {-a, 0.0f, -e3, -(e3 * r.py), -(a * r.pz - e3 * r.px),
                  a * r.py};
  if (!r.stereo) {
#pragma unroll
    for (int i = 0; i < 6; ++i) Jur[i] = 0.0f;
  }
  // Ju[1], Jv[0] and Jur[1] are identically 0: their products are left
  // out (exact, since the Jacobian entries are finite)
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) {
      const bool u = i != 1 && j != 1;  // Ju and Jur terms
      const bool v = i != 0 && j != 0;  // Jv term
      if (u && v)
        acc[k] += w * (Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jur[i] * Jur[j]);
      else if (u)
        acc[k] += w * (Ju[i] * Ju[j] + Jur[i] * Jur[j]);
      else if (v)
        acc[k] += w * (Jv[i] * Jv[j]);
    }
  acc[21] += w * (Ju[0] * r.eu + Jur[0] * r.eur);
  acc[22] += w * (Jv[1] * r.ev);
#pragma unroll
  for (int i = 2; i < 6; ++i)
    acc[21 + i] += w * (Ju[i] * r.eu + Jv[i] * r.ev + Jur[i] * r.eur);
  float cost = r.behind ? 1e7f : r.chi2 * w_rob;
  cost = isfinite(cost) ? cost : 1e7f;
  acc[kCost] += inl ? cost : 0.0f;
}

// One butterfly step of the warp reduce-scatter: each lane keeps half of
// its 2 * kHalf live values and adds the partner lane's copy of that half.
template <int kHalf>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

// A worker warp's sums of the kRed per-thread partials, in a fixed order:
// after the reduce-scatter lane q holds the warp's sum of quantity q, which
// it stores in warp_buf[warp][q].
__device__ __forceinline__ void warp_partials(const float (&acc)[kRed],
                                              float* warp_buf) {
  const int lane = threadIdx.x & 31;
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = i < kRed ? acc[i] : 0.0f;
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  warp_buf[(threadIdx.x >> 5) * 32 + lane] = v[0];
}

// Solver warp, after the barrier that follows a pass: quantity `lane` of
// the block sums, the workers' partials added in warp order (0 on lanes
// >= kRed).
__device__ __forceinline__ float block_sums(const float* warp_buf) {
  const int lane = threadIdx.x & 31;
  float s = warp_buf[lane];
#pragma unroll
  for (int w = 1; w < kWorkers; ++w) s += warp_buf[w * 32 + lane];
  return s;
}

// The edges of one problem, staged in shared memory. Worker thread tid owns
// edges tid, tid + kWorkerThreads, ... in every pass.
struct Staged {
  const float4* A;  // X Y Z inv_sigma2
  const float4* O;  // u v uR valid
  uint8_t* inl;     // current inlier flags
  int M;
};

__device__ __forceinline__ void load_pose(const float* P, float (&p)[12]) {
#pragma unroll
  for (int i = 0; i < 12; ++i) p[i] = P[i];
}

// Worker warps: the normal system at pose P, as warp partials (see
// block_sums). kReclassify first sets each edge's inlier flag on raw chi2,
// from the same residual.
template <bool kReclassify>
__device__ __forceinline__ void system_pass(const Staged& s, const float* P,
                                            const Cam& cam, bool robust,
                                            float* warp_buf) {
  float p[12];
  load_pose(P, p);
  float acc[kRed];
#pragma unroll
  for (int i = 0; i < kRed; ++i) acc[i] = 0.0f;
  for (int e = threadIdx.x; e < s.M; e += kWorkerThreads) {
    const float4 a = s.A[e];
    const float4 o = s.O[e];
    const Edge r = residual(p, cam, a, o);
    bool inl;
    if constexpr (kReclassify) {
      inl = within_gate(r, o.w != 0.0f);
      s.inl[e] = inl;
    } else {
      inl = s.inl[e] != 0;
    }
    accumulate(r, cam, a.w, inl, robust, acc);
  }
  warp_partials(acc, warp_buf);
}

// Worker warps: the last reclassification at pose P; writes the inlier
// mask, returns this thread's inlier count.
__device__ __forceinline__ int output_pass(const Staged& s, const float* P,
                                           const Cam& cam,
                                           uint8_t* inlier_out) {
  float p[12];
  load_pose(P, p);
  int cnt = 0;
  for (int e = threadIdx.x; e < s.M; e += kWorkerThreads) {
    const float4 o = s.O[e];
    const bool inl = within_gate(residual(p, cam, s.A[e], o), o.w != 0.0f);
    inlier_out[e] = inl;
    cnt += inl;
  }
  return cnt;
}

// Solve workspace in shared memory (warp 0 only).
struct SolveBuf {
  float Hs[36];  // scaled, damped system, row-major, both triangles
  float gs[6];
  float s[6];  // Jacobi scaling
  float r[6];  // refinement residual
};

// m[i][c] for a lane-dependent row i, by selects (a dynamic index would
// put m in local memory).
__device__ __forceinline__ float row_pick(const float (&m)[3][3], int i,
                                          int c) {
  return i == 0 ? m[0][c] : (i == 1 ? m[1][c] : m[2][c]);
}

// x = (L L^T)^-1 rhs, both triangles in the serial order of `_solve6`,
// multiplying by the reciprocal pivots inv[i] = 1 / L[i][i] that the
// factorization computed where `_solve6` divides by L[i][i]: 12 chained
// IEEE divisions per solve were the largest cost of the iteration.
__device__ __forceinline__ void chol_solve6(const float (&L)[6][6],
                                            const float (&inv)[6],
                                            const float (&rhs)[6],
                                            float (&x)[6]) {
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
    y[i] = acc * inv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) acc -= L[k][i] * x[k];
    x[i] = acc * inv[i];
  }
}

// Solver warp: solves the damped system whose 28 sums lane q holds in `sys`
// (`lm.solve_spd` / pose_opt_pallas._solve6: Jacobi scaling, lambda on the
// scaled diagonal, two refinement passes, dx = 0 where the system is not
// SPD or dx is not finite), then writes cand = se3_exp(dx) @ pose.
// (qa, qb): this lane's upper-triangle entry of H when lane < 21.
__device__ __forceinline__ void solve_step(float sys, float lam, int qa,
                                           int qb, const float* pose,
                                           float* cand, SolveBuf& ws) {
  const int lane = threadIdx.x & 31;
  __syncwarp();  // the previous solve's reads of ws are done
  // Jacobi scaling: lane i < 6 takes H_ii from the lane that holds it
  const int diag = lane < 6 ? lane * (13 - lane) / 2 : 0;
  const float hii = __shfl_sync(kFull, sys, diag);
  if (lane < 6) ws.s[lane] = 1.0f / sqrt_guard(fmaxf(hii, 1e-12f));
  __syncwarp();
  if (lane < 21) {
    const float sa = ws.s[qa], sb = ws.s[qb];
    const float dl = qa == qb ? lam : 0.0f;
    ws.Hs[qb * 6 + qa] = sys * sb * sa + dl;  // lower: H[j][i] s[j] s[i]
    ws.Hs[qa * 6 + qb] = sys * sa * sb + dl;  // upper: H[i][j] s[i] s[j]
  } else if (lane < 27) {
    ws.gs[lane - 21] = -sys * ws.s[lane - 21];
  }
  __syncwarp();

  // Cholesky, lock-step on every lane (serial order of `_solve6`); `spd`
  // tracks whether every pre-guard pivot was positive
  float L[6][6], inv[6];
  bool spd = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float acc = ws.Hs[i * 6 + i];
#pragma unroll
    for (int k = 0; k < i; ++k) acc -= L[i][k] * L[i][k];
    spd = spd && (acc > 0.0f);
    L[i][i] = sqrt_guard(acc);
    inv[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) {
      float a = ws.Hs[j * 6 + i];
#pragma unroll
      for (int k = 0; k < i; ++k) a -= L[j][k] * L[i][k];
      L[j][i] = a * inv[i];
    }
  }
  float rhs[6], y[6], dy[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) rhs[i] = ws.gs[i];
  chol_solve6(L, inv, rhs, y);
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if (lane < 6) {  // lane i: row i of the residual gs - Hs y
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += ws.Hs[lane * 6 + j] * y[j];
      ws.r[lane] = ws.gs[lane] - acc;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 6; ++i) rhs[i] = ws.r[i];
    __syncwarp();
    chol_solve6(L, inv, rhs, dy);
#pragma unroll
    for (int i = 0; i < 6; ++i) y[i] += dy[i];
  }
  float dx[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = y[i] * ws.s[i];
    dx[i] = (spd && isfinite(d)) ? d : 0.0f;
  }

  // se3_exp(dx) @ pose (dx = [v(3), w(3)]); lane k < 12 writes entry k
  const float v0 = dx[0], v1 = dx[1], v2 = dx[2];
  const float w0 = dx[3], w1 = dx[4], w2 = dx[5];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = th2 < 1e-8f;
  const float th = sqrtf(fmaxf(th2, 0.0f));
  const float sth = small ? 1.0f : th;
  const float sth2 = small ? 1.0f : th2;
  const float A = small ? 1.0f - th2 / 6.0f : sinf(sth) / sth;
  const float B = small ? 0.5f - th2 / 24.0f : (1.0f - cosf(sth)) / sth2;
  const float C =
      small ? 1.0f / 6.0f - th2 / 120.0f : (sth - sinf(sth)) / (sth2 * sth);
  const float W[3][3] = {{0.0f, -w2, w1}, {w2, 0.0f, -w0}, {-w1, w0, 0.0f}};
  float R[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float W2 = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
      const float e = (i == j) ? 1.0f : 0.0f;
      R[i][j] = e + A * W[i][j] + B * W2;
      V[i][j] = e + B * W[i][j] + C * W2;
    }
  if (lane < 12) {  // entry (i, j) of the 3x4 product
    const int i = lane >> 2, j = lane & 3;
    const float r0 = row_pick(R, i, 0), r1 = row_pick(R, i, 1),
                r2 = row_pick(R, i, 2);
    float out = r0 * pose[j] + r1 * pose[4 + j] + r2 * pose[8 + j];
    if (j == 3)
      out += row_pick(V, i, 0) * v0 + row_pick(V, i, 1) * v1 +
             row_pick(V, i, 2) * v2;
    cand[lane] = out;
  }
}

// R <- R (1.5 I - 0.5 R^T R), three times (se3.orthonormalize); writes the
// (4,4) pose.
__device__ void orthonormalize_store(const float* pose, float* out) {
  float R[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = pose[4 * i + j];
#pragma unroll
  for (int it = 0; it < 3; ++it) {
    float T[3][3], Rn[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float s = R[0][i] * R[0][j] + R[1][i] * R[1][j] +
                        R[2][i] * R[2][j];
        T[i][j] = (i == j ? 1.5f : 0.0f) - 0.5f * s;
      }
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        Rn[i][j] = R[i][0] * T[0][j] + R[i][1] * T[1][j] + R[i][2] * T[2][j];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = Rn[i][j];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) out[4 * i + j] = R[i][j];
    out[4 * i + 3] = pose[4 * i + 3];
  }
  out[12] = 0.0f;
  out[13] = 0.0f;
  out[14] = 0.0f;
  out[15] = 1.0f;
}

// pt_w (B,M,3), uv (B,M,2), ur / inv_sigma2 (B,M) f32, valid (B,M) u8,
// pose0 (B,4,4) f32 -> pose_out (B,4,4) f32, inlier_out (B,M) u8,
// n_out (B,) i32. All contiguous.
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ pt_w, const float* __restrict__ uv,
               const float* __restrict__ ur,
               const float* __restrict__ inv_sigma2,
               const uint8_t* __restrict__ valid,
               const float* __restrict__ pose0, Cam cam, int M, int n_rounds,
               int n_iters, float* __restrict__ pose_out,
               uint8_t* __restrict__ inlier_out, int* __restrict__ n_out) {
  extern __shared__ float4 smem4[];
  float4* sA = smem4;      // X Y Z inv_sigma2
  float4* sO = sA + M;     // u v uR valid
  uint8_t* sInl = reinterpret_cast<uint8_t*>(sO + M);

  __shared__ float warp_buf[kWorkers * 32];
  __shared__ float pose[12];
  __shared__ float cand[12];  // the candidate the workers evaluate
  __shared__ float spec[12];  // the next candidate if this step is rejected
  __shared__ SolveBuf ws;
  __shared__ int warp_cnt[kWorkers];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool solver = warp == kWorkers;
  const size_t base = static_cast<size_t>(b) * M;
  for (int e = tid; e < M; e += kThreads) {
    const size_t i = base + e;
    const bool v = valid[i] != 0;
    sA[e] = make_float4(pt_w[3 * i], pt_w[3 * i + 1], pt_w[3 * i + 2],
                        inv_sigma2[i]);
    sO[e] = make_float4(uv[2 * i], uv[2 * i + 1], ur[i], v ? 1.0f : 0.0f);
    sInl[e] = v;
  }
  if (tid < 12) pose[tid] = pose0[b * 16 + tid];
  // this lane's upper-triangle entry (qa <= qb) of H, for the solve; row
  // a starts at index a * (13 - a) / 2
  int qa = 0, qb = 0;
  if (lane < 21) {
    while (lane >= (qa + 1) * (12 - qa) / 2) ++qa;
    qb = qa + lane - qa * (13 - qa) / 2;
  }
  __syncthreads();

  const Staged st{sA, sO, sInl, M};
  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < 2;  // kernels dropped from round 2
    // the system at the round's starting pose, then the first candidate;
    // the solver warp keeps the system (lane q: sum q) and lambda
    if (!solver) {
      if (rnd == 0)
        system_pass<false>(st, pose, cam, robust, warp_buf);
      else
        system_pass<true>(st, pose, cam, robust, warp_buf);
    }
    __syncthreads();
    float lam = 1e-4f, sys = 0.0f;
    if (solver) {
      sys = block_sums(warp_buf);
      if (n_iters > 0) solve_step(sys, lam, qa, qb, pose, cand, ws);
    }
    __syncthreads();
    for (int it = 0; it < n_iters; ++it) {
      const bool more = it + 1 < n_iters;
      const float lam_up = fminf(fmaxf(lam * 4.0f, 1e-10f), 1e6f);
      if (!solver)
        system_pass<false>(st, cand, cam, robust, warp_buf);
      else if (more)  // meanwhile: the next candidate if this step fails
        solve_step(sys, lam_up, qa, qb, pose, spec, ws);
      __syncthreads();
      if (solver) {
        const float cand_sys = block_sums(warp_buf);
        const bool accept = __shfl_sync(kFull, cand_sys, kCost) <
                            __shfl_sync(kFull, sys, kCost);
        if (accept) {
          sys = cand_sys;
          lam = fminf(fmaxf(lam * 0.5f, 1e-10f), 1e6f);
          if (lane < 12) pose[lane] = cand[lane];
          __syncwarp();
          if (more) solve_step(sys, lam, qa, qb, pose, cand, ws);
        } else {
          lam = lam_up;
          if (more && lane < 12) cand[lane] = spec[lane];
        }
      }
      __syncthreads();
    }
  }

  // the last reclassification, the mask and an exact inlier count
  if (!solver) {
    const int cnt = __reduce_add_sync(
        kFull, output_pass(st, pose, cam, inlier_out + base));
    if (lane == 0) warp_cnt[warp] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWorkers; ++w) total += warp_cnt[w];
    n_out[b] = total;
    orthonormalize_store(pose, pose_out + b * 16);
  }
}

}  // namespace

extern "C" {

// Once per device (with that device current): opts the kernel into the
// largest dynamic shared memory the device allows. Returns the largest
// edge count one block can stage, or -(CUDA error) on failure.
int pose_lm_init(int device) {
  int max_optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &max_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, pose_lm_kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int dyn = max_optin - static_cast<int>(attr.sharedSizeBytes);
  err = cudaFuncSetAttribute(
      pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return dyn / kEdgeBytes;
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int pose_lm_launch(const float* pt_w, const float* uv, const float* ur,
                   const float* inv_sigma2, const uint8_t* valid,
                   const float* pose0, float fx, float fy, float cx, float cy,
                   float bf, int B, int M, int n_rounds, int n_iters,
                   float* pose_out, uint8_t* inlier_out, int* n_out,
                   void* stream) {
  const size_t smem = static_cast<size_t>(M) * kEdgeBytes;
  const Cam cam{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pt_w, uv, ur, inv_sigma2, valid, pose0, cam, M, n_rounds, n_iters,
      pose_out, inlier_out, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Motion-only pose optimization (`Optimizer::PoseOptimization`,
// src/Optimizer.cc:239-451) as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_pose_lm_kernel`
// (orbslam_mapsave_tpu/optim/pose_opt_pallas.py), and computes exactly what
// it computes: 4 rounds x 10 Levenberg-Marquardt iterations over M
// reprojection edges (mono and stereo-uR mixed), Huber weights on rounds
// 0-1, the 21 H + 6 g + cost reductions of the normal system, a
// Jacobi-scaled damped 6x6 Cholesky with two refinement passes (a system
// that is not SPD gives dx = 0), a left SE3-exp update, strict-< acceptance
// with lambda x0.5 / x4 clipped to [1e-10, 1e6], and inlier
// reclassification on raw chi2 between rounds.
//
// What bounds it on the card: launch and latency, not bytes or FLOPs. The
// input is 32 bytes per edge (64 KB at M = 2048) and the arithmetic is a
// few hundred thousand FLOPs, but the schedule is 40 dependent iterations,
// each with two block-wide reductions (~80 barriers in all) and a serial
// 6x6 solve. The design therefore keeps the whole solve in ONE launch per
// problem: the edge data is staged once into shared memory (dynamic shared
// memory, above the 48 KB default), every reduction is warp shuffles plus
// one shared-memory pass in a fixed order (no atomics, so results are
// bit-for-bit repeatable), and one thread does the 6x6 solve and the SE3
// update while the others wait at the barrier. One block per problem: a
// leading batch dimension B maps to a grid of B blocks.
//
// Plain C interface, built with nvcc and loaded with ctypes
// (optim/pose_opt_cuda.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 28;  // 21 H upper triangle + 6 g + cost
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

__device__ __forceinline__ float sqrt_guard(float x) {
  return sqrtf(fmaxf(x, 1e-20f));
}

struct Cam {
  float fx, fy, cx, cy, bf;
};

// Per-edge residual terms at `pose` (12 floats, row-major 3x4).
struct Edge {
  float px, py, pz, zi, eu, ev, eur, chi2;
  bool behind, stereo;
};

__device__ __forceinline__ Edge residual(const float* pose, const Cam& c,
                                         float X, float Y, float Z, float U,
                                         float V, float UR, float IS2) {
  Edge e;
  e.px = pose[0] * X + pose[1] * Y + pose[2] * Z + pose[3];
  e.py = pose[4] * X + pose[5] * Y + pose[6] * Z + pose[7];
  e.pz = pose[8] * X + pose[9] * Y + pose[10] * Z + pose[11];
  const float zsafe = fabsf(e.pz) < 1e-9f ? 1e-9f : e.pz;
  e.zi = 1.0f / zsafe;
  const float u_hat = c.fx * e.px * e.zi + c.cx;
  const float v_hat = c.fy * e.py * e.zi + c.cy;
  const float ur_hat = u_hat - c.bf * e.zi;
  e.stereo = UR >= 0.0f;
  e.eu = U - u_hat;
  e.ev = V - v_hat;
  e.eur = e.stereo ? UR - ur_hat : 0.0f;
  e.chi2 = (e.eu * e.eu + e.ev * e.ev + e.eur * e.eur) * IS2;
  e.behind = e.pz <= 0.0f;
  return e;
}

__device__ __forceinline__ float robust_weight(float chi2, float delta2,
                                               bool robust) {
  return (robust && chi2 > delta2) ? sqrt_guard(delta2) / sqrt_guard(chi2)
                                   : 1.0f;
}

__device__ __forceinline__ float cost_term(const Edge& e, float w_rob) {
  float val = e.behind ? 1e7f : e.chi2 * w_rob;
  return isfinite(val) ? val : 1e7f;
}

// Block-wide sums of `n` per-thread values in a fixed order: a shuffle tree
// inside each warp, then warp partials summed in warp order by thread 0.
// Result lands in out[0..n); every thread may read it after the call.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* warp_buf,
                                          float* out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) warp_buf[warp * N + i] = x;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < N; ++i) {
      float s = warp_buf[i];
      for (int w = 1; w < kWarps; ++w) s += warp_buf[w * N + i];
      out[i] = s;
    }
  }
  __syncthreads();
}

// Jacobi-scaled damped 6x6 Cholesky solve with two refinement passes
// (`lm.solve_spd` / pose_opt_pallas._solve6). Returns dx = 0 where the
// system is not SPD or the result is not finite.
__device__ void solve6(const float (&H)[6][6], const float (&g)[6], float lam,
                       float (&dx)[6]) {
  float s[6], Hs[6][6], gs[6], L[6][6];
  for (int i = 0; i < 6; ++i) s[i] = 1.0f / sqrt_guard(fmaxf(H[i][i], 1e-12f));
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) {
      Hs[i][j] = H[i][j] * s[i] * s[j] + (i == j ? lam : 0.0f);
      L[i][j] = 0.0f;
    }
    gs[i] = g[i] * s[i];
  }
  bool spd = true;
  for (int i = 0; i < 6; ++i) {
    float acc = Hs[i][i];
    for (int k = 0; k < i; ++k) acc -= L[i][k] * L[i][k];
    spd = spd && (acc > 0.0f);
    L[i][i] = sqrt_guard(acc);
    const float inv_d = 1.0f / L[i][i];
    for (int j = i + 1; j < 6; ++j) {
      float a = Hs[j][i];
      for (int k = 0; k < i; ++k) a -= L[j][k] * L[i][k];
      L[j][i] = a * inv_d;
    }
  }
  auto chol_solve = [&](const float (&rhs)[6], float (&x)[6]) {
    float y[6];
    for (int i = 0; i < 6; ++i) {
      float acc = rhs[i];
      for (int k = 0; k < i; ++k) acc -= L[i][k] * y[k];
      y[i] = acc / L[i][i];
    }
    for (int i = 5; i >= 0; --i) {
      float acc = y[i];
      for (int k = i + 1; k < 6; ++k) acc -= L[k][i] * x[k];
      x[i] = acc / L[i][i];
    }
  };
  float y[6];
  chol_solve(gs, y);
  for (int pass = 0; pass < 2; ++pass) {
    float r[6], dy[6];
    for (int i = 0; i < 6; ++i) {
      float acc = 0.0f;
      for (int j = 0; j < 6; ++j) acc += Hs[i][j] * y[j];
      r[i] = gs[i] - acc;
    }
    chol_solve(r, dy);
    for (int i = 0; i < 6; ++i) y[i] += dy[i];
  }
  for (int i = 0; i < 6; ++i) {
    const float d = y[i] * s[i];
    dx[i] = (spd && isfinite(d)) ? d : 0.0f;
  }
}

// new_pose = se3_exp(dx) @ pose (dx = [v(3), w(3)], translation first).
__device__ void se3_exp_mul(const float (&dx)[6], const float* pose,
                            float* out) {
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
  float W2[3][3], R[3][3], Vm[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      W2[i][j] = W[i][0] * W[0][j] + W[i][1] * W[1][j] + W[i][2] * W[2][j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float e = (i == j) ? 1.0f : 0.0f;
      R[i][j] = e + A * W[i][j] + B * W2[i][j];
      Vm[i][j] = e + B * W[i][j] + C * W2[i][j];
    }
  float t[3];
  for (int i = 0; i < 3; ++i)
    t[i] = Vm[i][0] * v0 + Vm[i][1] * v1 + Vm[i][2] * v2;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j)
      out[4 * i + j] = R[i][0] * pose[j] + R[i][1] * pose[4 + j] +
                       R[i][2] * pose[8 + j];
    out[4 * i + 3] =
        R[i][0] * pose[3] + R[i][1] * pose[7] + R[i][2] * pose[11] + t[i];
  }
}

// data: (B, 8, M) f32 rows X Y Z U V UR IS2 VALID; pose0: (B, 12) f32;
// pose_out: (B, 16) f32; inlier_out: (B, M) u8.
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ data, const float* __restrict__ pose0,
               Cam cam, int M, int n_rounds, int n_iters,
               float* __restrict__ pose_out, uint8_t* __restrict__ inlier_out) {
  extern __shared__ float smem[];
  float* sX = smem;
  float* sY = sX + M;
  float* sZ = sY + M;
  float* sU = sZ + M;
  float* sV = sU + M;
  float* sUR = sV + M;
  float* sIS2 = sUR + M;
  uint8_t* sValid = reinterpret_cast<uint8_t*>(sIS2 + M);
  uint8_t* sInl = sValid + M;

  __shared__ float warp_buf[kWarps * kRed];
  __shared__ float red[kRed];
  __shared__ float pose[12];
  __shared__ float new_pose[12];
  __shared__ float lam_s;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* src = data + static_cast<size_t>(b) * 8 * M;
  for (int e = tid; e < M; e += kThreads) {
    sX[e] = src[e];
    sY[e] = src[M + e];
    sZ[e] = src[2 * M + e];
    sU[e] = src[3 * M + e];
    sV[e] = src[4 * M + e];
    sUR[e] = src[5 * M + e];
    sIS2[e] = src[6 * M + e];
    const uint8_t v = src[7 * M + e] > 0.5f ? 1 : 0;
    sValid[e] = v;
    sInl[e] = v;
  }
  if (tid < 12) pose[tid] = pose0[b * 12 + tid];
  __syncthreads();

  for (int rnd = 0; rnd < n_rounds; ++rnd) {
    const bool robust = rnd < 2;  // kernels dropped from round 2
    if (tid == 0) lam_s = 1e-4f;
    __syncthreads();
    for (int it = 0; it < n_iters; ++it) {
      // ---- normal system at `pose` ----
      float acc[kRed];
#pragma unroll
      for (int i = 0; i < kRed; ++i) acc[i] = 0.0f;
      for (int e = tid; e < M; e += kThreads) {
        const Edge r = residual(pose, cam, sX[e], sY[e], sZ[e], sU[e], sV[e],
                                sUR[e], sIS2[e]);
        const bool inl = sInl[e] != 0;
        const float delta2 = r.stereo ? kChi2Stereo : kChi2Mono;
        const float w_rob = robust_weight(r.chi2, delta2, robust);
        const float w = (inl && !r.behind) ? sIS2[e] * w_rob : 0.0f;
        const float zi2 = r.zi * r.zi;
        const float a = cam.fx * r.zi;
        const float c = -cam.fx * r.px * zi2;
        const float bb = cam.fy * r.zi;
        const float d = -cam.fy * r.py * zi2;
        const float Ju[6] = {-a, 0.0f, -c, -(c * r.py), -(a * r.pz - c * r.px),
                             a * r.py};
        const float Jv[6] = {0.0f, -bb, -d, -(-bb * r.pz + d * r.py),
                             d * r.px, -bb * r.px};
        const float e3 = c + cam.bf * zi2;  // d(uR)/dPz
        float Jur[6] = {-a, 0.0f, -e3, -(e3 * r.py), -(a * r.pz - e3 * r.px),
                        a * r.py};
        if (!r.stereo) {
#pragma unroll
          for (int i = 0; i < 6; ++i) Jur[i] = 0.0f;
        }
        int k = 0;
#pragma unroll
        for (int i = 0; i < 6; ++i)
#pragma unroll
          for (int j = i; j < 6; ++j)
            acc[k++] += w * (Ju[i] * Ju[j] + Jv[i] * Jv[j] + Jur[i] * Jur[j]);
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc[21 + i] += w * (Ju[i] * r.eu + Jv[i] * r.ev + Jur[i] * r.eur);
        acc[27] += inl ? cost_term(r, w_rob) : 0.0f;
      }
      block_sum(acc, warp_buf, red);

      // ---- 6x6 solve + SE3 update (one thread) ----
      if (tid == 0) {
        float H[6][6], g[6], dx[6];
        int k = 0;
        for (int i = 0; i < 6; ++i)
          for (int j = i; j < 6; ++j) {
            H[i][j] = red[k];
            H[j][i] = red[k];
            ++k;
          }
        for (int i = 0; i < 6; ++i) g[i] = -red[21 + i];
        solve6(H, g, lam_s, dx);
        se3_exp_mul(dx, pose, new_pose);
      }
      const float chi2_old = red[27];
      __syncthreads();

      // ---- acceptance cost at `new_pose` ----
      float cost[1] = {0.0f};
      for (int e = tid; e < M; e += kThreads) {
        if (sInl[e] == 0) continue;
        const Edge r = residual(new_pose, cam, sX[e], sY[e], sZ[e], sU[e],
                                sV[e], sUR[e], sIS2[e]);
        const float delta2 = r.stereo ? kChi2Stereo : kChi2Mono;
        cost[0] += cost_term(r, robust_weight(r.chi2, delta2, robust));
      }
      block_sum(cost, warp_buf, red);
      if (tid == 0) {
        const bool accept = red[0] < chi2_old;
        if (accept)
          for (int i = 0; i < 12; ++i) pose[i] = new_pose[i];
        const float lam = accept ? lam_s * 0.5f : lam_s * 4.0f;
        lam_s = fminf(fmaxf(lam, 1e-10f), 1e6f);
      }
      __syncthreads();
    }
    // ---- inter-round reclassification against raw chi2 ----
    for (int e = tid; e < M; e += kThreads) {
      const Edge r = residual(pose, cam, sX[e], sY[e], sZ[e], sU[e], sV[e],
                              sUR[e], sIS2[e]);
      const float delta2 = r.stereo ? kChi2Stereo : kChi2Mono;
      sInl[e] = (sValid[e] && r.chi2 <= delta2 && !r.behind) ? 1 : 0;
    }
    __syncthreads();
  }

  if (tid < 12) pose_out[b * 16 + tid] = pose[tid];
  if (tid >= 12 && tid < 16) pose_out[b * 16 + tid] = tid == 15 ? 1.0f : 0.0f;
  for (int e = tid; e < M; e += kThreads)
    inlier_out[static_cast<size_t>(b) * M + e] = sInl[e];
}

}  // namespace

extern "C" {

// Dynamic shared memory per block for M edges: seven f32 rows + two u8 rows.
static size_t pose_lm_smem_bytes(int M) {
  return static_cast<size_t>(M) * (7 * sizeof(float) + 2);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
int pose_lm_launch(const float* data, const float* pose0, float fx, float fy,
                   float cx, float cy, float bf, int B, int M, int n_rounds,
                   int n_iters, float* pose_out, uint8_t* inlier_out,
                   void* stream) {
  const size_t smem = pose_lm_smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(
      pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Cam cam{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      data, pose0, cam, M, n_rounds, n_iters, pose_out, inlier_out);
  return static_cast<int>(cudaGetLastError());
}

// Largest edge count one block can stage (for the wrapper's shape check).
int pose_lm_max_edges(int device) {
  int max_optin = 0;
  if (cudaDeviceGetAttribute(&max_optin,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  const int static_bytes = (kWarps * kRed + kRed + 12 + 12 + 1) * 4;
  return (max_optin - static_bytes) / (7 * 4 + 2);
}

}  // extern "C"

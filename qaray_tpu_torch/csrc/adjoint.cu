// Fused adjoint (K6): the gradient of sum(radiance * ct) with respect to the
// differentiable scene parameters (materials' diffuse, specular, emission,
// reflection, refraction colours and glossiness, the lights' intensities,
// the background and environment colours) for pathtrace lanes, in one
// launch.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_adjoint.py
// ::_make_adjoint_kernel (dispatched by adjoint_render), with its helper
// _light_factor. With detached sampling (the lobe pdfs and the sampled
// directions carry no gradient) a lane's radiance is
//
//     L_c = sum_j beta_{j,c} * c_{j,c} + miss terms,  beta_{j+1} = beta_j w_j
//
// with every w_j and c_j linear in the colours (and pow(cosNH, gloss) in
// the glossiness). Each thread takes one lane, as K1a does, and replays its
// path with K1a's own device code (mega_common.cuh: the same closest hits,
// the K1c mesh sweep, the same soft-shadow draws, Fresnel terms, lobe
// selection and continuations, so the same paths draw for draw). On the way
// it adds the gradients of each vertex's direct and emitted terms, c_j, and
// of the misses, and stores the hooks of the reverse beta-chain: per
// bounce e_j = (miss colour or c_j) * ct, beta_j, w_j, the lobe and
// material row, and the lobe weight's coefficients. Then it walks the
// bounces backwards with the adjoint A of beta (A_j = e_j + w_j A_{j+1}),
// adding beta_j A_{j+1} times the coefficients to the lobe's colours.
//
// What the TPU design did that this one does not: the hooks lived in
// registers of an unrolled bounce loop, and the sums were placed into one
// [rows, 128] tile per block with iota masks (Mosaic has neither scalar
// stores nor scatters). Here the hooks go to a global scratch buffer
// [hook][bounce][lane] (coalesced; per-thread arrays would spill to local
// memory past the 128-register budget of a 128-thread block), and each
// thread adds its terms with plain adds to its own column of the block's
// [n_params][128] sums in shared memory: no two threads touch one
// address, so nothing waits on an atomic (with the sums as atomics on one
// row, a warp whose lanes all missed added to the same 3 background sums
// 32 deep). At the block's end a tree in a fixed order folds the columns
// into one partial row a block, and the wrapper sums the rows (torch.sum,
// as the JAX package sums its partials in XLA). Every sum has a fixed
// order, so two launches on the same inputs give the same bits.
//
// What bounds it on the H100: operations, as K1a: the replay does K1a's
// primitive tests, triangle tests and threefry ciphers (counted per lane in
// `work`), plus 52 bytes a lane a bounce of hooks written and read back.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega_common.cuh"

// Launch and shared memory through the macros csrc/host/cuda_runtime.h
// redefines for the CPU tests (ops/_build.load_host), as in megakernel.cu.
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

constexpr int kLogThreads = 7, kThreads = 1 << kLogThreads;
constexpr int MAX_ROWS = 8, MAX_LIGHTS = 8;  // pallas_adjoint's gate
// Parameter layout (pallas_adjoint.param_layout): 16 a material row
// (diffuse 3, specular 3, emission 3, reflection 3, refraction 3,
// glossiness 1), then 3 a light, then background 3 and environment 3.
constexpr int G_DIFF = 0, G_SPEC = 3, G_EMIT = 6, G_REFL = 9, G_REFR = 12,
              G_GLOSS = 15, G_ROW = 16;
// Hooks a bounce: e (3), beta (3), w (3), code = row * 8 + lobe (lobe 0
// none, 1 refraction, 2 reflection, 3 specular, 4 diffuse), the lobe's
// coefficients ca, cb and log(cosNH) of the specular lobe.
constexpr int H_E = 0, H_BETA = 3, H_W = 6, H_CODE = 9, H_CA = 10, H_CB = 11,
              H_LN = 12, NUM_HOOKS = 13;

struct Params {
  const int* px;
  const int* py;
  const int* sid;
  int n;
  const float* prim;
  const int* kinds;
  const int* prim_mtl;
  int num_prims;
  const float* mtl;  // [M, 22]
  int num_mtls;
  const float* light;
  const int* lkind;
  const int* lsoft;
  int num_lights;
  float light_norm;  // (1 / num_lights) ^ 2
  const float* cam;
  uint32_t key0, key1;
  int width;
  int max_bounce;
  int shadow_spp, shadow_spp_max;
  const float4* mrows;  // K1c's mesh tables, n_leaves 0 without a mesh
  const float4* mattr;
  const float* mtree;
  int n_leaves, leaf_rows;
  const float* ct;  // [n, 3] radiance cotangent
  float* hooks;     // [NUM_HOOKS, max_bounce + 1, n] scratch
  float* out;       // [n_rows, n_params] block sums, zeroed by the caller
  int n_rows;
  int n_params;
  int* work;  // optional [n, 4]: prim tests, ciphers, vertices, tri tests
};

// A thread's gradient sums: its own column of the block's
// [n_params][kThreads] array in shared memory, term k at col[k * kThreads],
// added to with plain adds in the thread's program order.
struct Sums {
  float* col;
  __device__ __forceinline__ void add(int k, float v) const {
    col[k * kThreads] += v;
  }
  __device__ __forceinline__ void add3(int k, V3 a) const {
    add(k, a.x);
    add(k + 1, a.y);
    add(k + 2, a.z);
  }
};

// One bounce's hooks, at hk[h * stride] for hook h.
__device__ __forceinline__ void store_hooks(float* hk, size_t stride, V3 e,
                                            V3 beta, V3 w, int code,
                                            float ca, float cb, float ln) {
  const float v[NUM_HOOKS] = {e.x,    e.y,    e.z,  beta.x,      beta.y,
                              beta.z, w.x,    w.y,  w.z,         (float)code,
                              ca,     cb,     ln};
  for (int h = 0; h < NUM_HOOKS; ++h) hk[h * stride] = v[h];
}

// Replay of lane `lane`'s path (mega_kernel<false, false>'s pathtrace
// branch) and its reverse sweep, adding into the thread's sums g.
template <class PT>
__device__ void adjoint_lane(const PT& P, const Shared& S, const Sums& g,
                             int lane) {
  Work w{0, 0, 0, 0, 0, 0, 0};
  const int nb = P.max_bounce + 1;
  const size_t stride = (size_t)nb * P.n;  // between hooks
  float* hk = P.hooks + lane;              // + b * n for bounce b
  const int lb = P.num_mtls * G_ROW;       // first light gradient
  const int eb = lb + 3 * P.num_lights;    // background, environment

  const int px = P.px[lane], py = P.py[lane], sid = P.sid[lane];
  const uint32_t rid = (uint32_t)py * (uint32_t)P.width + (uint32_t)px;
  const Key kr =
      fold_w(Key{P.key0, P.key1}, rid * 65536u + (uint32_t)sid, w);
  const float tx = (float)px + halton(sid, 11);
  const float ty = (float)py + halton(sid, 13);
  const V3 ca = load3(S.cam + CAM_A), cu = load3(S.cam + CAM_U),
           cv = load3(S.cam + CAM_V);
  const V3 cpt = V3{ca.x + tx * cu.x + ty * cv.x, ca.y + tx * cu.y + ty * cv.y,
                    ca.z + tx * cu.z + ty * cv.z};
  V3 p = load3(S.cam + CAM_POS);
  V3 d = norm3(sub3(cpt, p));
  const V3 ct = load3(P.ct + 3 * (size_t)lane);
  const V3 zero = V3{0.0f, 0.0f, 0.0f};

  V3 beta = V3{1.0f, 1.0f, 1.0f};
  int stored = 0;
  for (int bounce = 0; bounce <= P.max_bounce; ++bounce) {
    float* hb = hk + (size_t)bounce * P.n;
    stored = bounce + 1;
    Hit hit = closest_hit<false>(S.prim, S.kinds, P.num_prims, p, d);
    w.tests += P.num_prims;
    int mesh_row = -1;
    if constexpr (PT::kMesh) mesh_closest(P, p, d, hit, &mesh_row, w);
    if (!(hit.t < QR_BIGFLOAT)) {
      // radiance += beta * (background at bounce 0, environment after).
      g.add3(eb + (bounce == 0 ? 0 : 3), mul3(beta, ct));
      const V3 mc = load3(S.cam + (bounce == 0 ? CAM_BG : CAM_ENV));
      store_hooks(hb, stride, mul3(mc, ct), beta, zero, 0, 0.0f, 0.0f, 0.0f);
      break;
    }
    ++w.vertices;
    const int row = mesh_row >= 0 ? mesh_row : S.prim_mtl[hit.prim];
    const float* mrow = S.mtl + row * MTL_COLS;
    const int gr = row * G_ROW;
    const V3 diffuse = load3(mrow + MT_DIFF), specular = load3(mrow + MT_SPEC),
             emit = load3(mrow + MT_EMIT), t_k = load3(mrow + MT_REFR),
             r_k = load3(mrow + MT_REFL);
    const float gloss = mrow[MT_GLOSS], rgloss = mrow[MT_RGLOSS],
                tgloss = mrow[MT_TGLOSS], ior = mrow[MT_IOR];
    const V3 hp = add3(p, scale3(d, hit.t));
    const V3 n = norm3(hit.n, 1e-30f);
    const bool front = hit.front;
    const V3 v = neg3(d);
    const Key kb = fold_w(kr, (uint32_t)(1000 + bounce), w);

    // Fresnel and the lobe select, as mega_kernel's pathtrace branch.
    const float cos_nv = dot3(n, v);
    const V3 y = cos_nv > 0.0f ? n : neg3(n);
    const V3 x = norm3(cross3(y, cross3(v, y)), 1e-30f);
    const float n_ior = front ? 1.0f / ior : ior;
    const float cos_i = cos_nv;
    const float sin_i = sqrtf(fmaxf(0.0f, 1.0f - cos_i * cos_i));
    const float sin_o = fminf(fmaxf(sin_i * n_ior, 0.0f), 1.0f);
    const float cos_o = sqrtf(fmaxf(0.0f, 1.0f - sin_o * sin_o));
    const bool total_refl = (n_ior * sin_i) > 1.001f;
    const float c0 =
        (n_ior - 1.0f) * (n_ior - 1.0f) / ((n_ior + 1.0f) * (n_ior + 1.0f));
    const float r_ratio = c0 + (1.0f - c0) * powf(1.0f - fabsf(cos_i), 5.0f);
    // Detached coefficients of the sample colours:
    //   samp_refr = tfac * refraction, samp_refl = reflection + rr_eff *
    //   refraction.
    const float tfac = total_refl ? 0.0f : 1.0f - r_ratio;
    const float rr_eff = total_refl ? 1.0f : r_ratio;
    const V3 samp_refr =
        total_refl ? V3{0.0f, 0.0f, 0.0f} : scale3(t_k, 1.0f - r_ratio);
    const V3 samp_refl =
        total_refl ? add3(r_k, t_k) : add3(r_k, scale3(t_k, r_ratio));
    const float select = draw_w(fold_w(kb, P_LOBE_SELECT, w), 0, w);
    const float coef_refr = max3(samp_refr), coef_refl = max3(samp_refl),
                coef_spec = max3(specular), coef_diff = max3(diffuse);
    const float coef_sum =
        fmaxf(coef_refr + coef_refl + coef_spec + coef_diff, 1e-20f);
    const float c_refr = coef_refr / coef_sum, c_refl = coef_refl / coef_sum,
                c_spec = coef_spec / coef_sum, c_diff = coef_diff / coef_sum;
    const float sum_refl = c_refr + c_refl;
    const float sum_spec = sum_refl + c_spec;
    const bool sel_refr = (select <= c_refr) && (c_refr > 1e-6f);
    const bool sel_refl = !sel_refr && (select < sum_refl) && (c_refl > 1e-6f);
    const bool sel_spec = !sel_refr && !sel_refl && (select < sum_spec) &&
                          (c_spec > 1e-6f);
    const bool sel_diff =
        !sel_refr && !sel_refl && !sel_spec && (c_diff > 1e-6f);

    // Direct light and emission, c_j, with their gradients at once:
    // factor = beta * ct is the adjoint of c_j (_light_factor's V times
    // the spot cone is the light's scalar weight).
    const V3 fac = mul3(beta, ct);
    V3 direct = zero, gd = zero, gs = zero;
    float gl = 0.0f;
    for (int li = 0; li < P.num_lights; ++li) {
      const int kind = S.lkind[li];
      if (kind == LIGHT_AMBIENT) continue;
      const float* lt = S.light + li * LIGHT_COLS;
      float vf = light_visibility(P, S, li, hp, kb, w);
      if (kind == LIGHT_SPOT) vf = vf * spot_attenuation(lt, hp);
      const V3 inten = load3(lt + LT_INT);
      V3 l_dir;
      if (kind == LIGHT_DIRECT) {
        l_dir = norm3(neg3(load3(lt + LT_DIR)), 1e-30f);
      } else {
        const V3 to_p = norm3(sub3(hp, load3(lt + LT_POS)), 1e-30f);
        l_dir = norm3(neg3(to_p), 1e-30f);
      }
      const V3 h = norm3(add3(v, l_dir), 1e-30f);
      const float cos_nl = fmaxf(0.0f, dot3(n, l_dir));
      const float cos_nh = fmaxf(0.0f, dot3(n, h));
      const float sw = pow_safe(cos_nh, gloss);
      const float ln_nh = logf(fmaxf(cos_nh, 1e-6f));
      const float wgt = P.light_norm * vf * cos_nl;
      const V3 dk = add3(diffuse, scale3(specular, sw));
      direct = add3(direct, scale3(mul3(inten, dk), wgt));
      g.add3(lb + 3 * li, scale3(mul3(fac, dk), wgt));
      const V3 base = scale3(mul3(fac, inten), wgt);
      gd = add3(gd, base);
      gs = add3(gs, scale3(base, sw));
      gl = gl + dot3(base, specular) * sw * ln_nh;
    }
    g.add3(gr + G_DIFF, gd);
    g.add3(gr + G_SPEC, gs);
    g.add3(gr + G_EMIT, fac);
    g.add(gr + G_GLOSS, gl);
    const V3 e = mul3(add3(emit, direct), ct);

    const bool go_spec = sel_spec && front;
    const bool go_diff = sel_diff && front;
    if (bounce == P.max_bounce ||
        !(sel_refr || sel_refl || go_spec || go_diff)) {
      store_hooks(hb, stride, e, beta, zero, 0, 0.0f, 0.0f, 0.0f);
      break;
    }

    // Continuation (MtlBlinn_PathTracing.cpp:176-297), as mega_kernel.
    const V3 t_dir = V3{-x.x * sin_o - y.x * cos_o, -x.y * sin_o - y.y * cos_o,
                        -x.z * sin_o - y.z * cos_o};
    const V3 r_dir = V3{2.0f * n.x * cos_nv - v.x, 2.0f * n.y * cos_nv - v.y,
                        2.0f * n.z * cos_nv - v.z};
    const Key kh = fold_w(kb, P_LOBE_SAMPLE, w);
    const float u0 = draw_w(kh, 0, w), u1 = draw_w(kh, 1, w);
    const float cth = sqrtf(u0);
    const float sth = sqrtf(fmaxf(0.0f, 1.0f - u0));
    const float phi = TWO_PI * u1;
    const V3 hemi = norm3(V3{sth * cosf(phi), sth * sinf(phi), cth}, 1e-30f);
    const V3 hemi_world = to_local_frame(y, hemi);
    V3 new_dir, bxdf;
    float pdf, wfac = 1.0f, ln = 0.0f;
    int lobe;
    if (sel_refr) {
      const bool glossy = tgloss > 0.0f;
      new_dir = glossy ? neg3(hemi_world) : t_dir;
      if (glossy) wfac = pow_safe(fmaxf(0.0f, dot3(v, t_dir)), tgloss);
      bxdf = glossy ? scale3(samp_refr, wfac) : samp_refr;
      pdf = c_refr;
      lobe = 1;
    } else if (sel_refl) {
      const bool glossy = rgloss > 0.0f;
      new_dir = glossy ? hemi_world : r_dir;
      if (glossy) wfac = pow_safe(fmaxf(0.0f, dot3(v, r_dir)), rgloss);
      bxdf = glossy ? scale3(samp_refl, wfac) : samp_refl;
      pdf = c_refl;
      lobe = 2;
    } else if (go_spec) {
      const V3 h = norm3(add3(v, norm3(hemi_world, 1e-30f)), 1e-30f);
      const float cos_nh = fmaxf(0.0f, dot3(n, h));
      new_dir = hemi_world;
      wfac = pow_safe(cos_nh, gloss);
      ln = logf(fmaxf(cos_nh, 1e-6f));
      bxdf = scale3(specular, wfac);
      pdf = c_spec;
      lobe = 3;
    } else {
      new_dir = hemi_world;
      bxdf = diffuse;
      pdf = c_diff;
      lobe = 4;
    }
    const float inv_pdf = 1.0f / fmaxf(pdf, 1e-20f);
    // d w / d colour: refraction lobe tfac * wfac (refraction); reflection
    // lobe rr_eff * wfac (refraction) and wfac (reflection); specular wfac;
    // diffuse 1; each over the pdf.
    const float cb = lobe == 2 ? inv_pdf * wfac : 0.0f;
    const float ca = lobe == 1   ? inv_pdf * tfac * wfac
                     : lobe == 2 ? inv_pdf * rr_eff * wfac
                                 : inv_pdf * wfac;
    store_hooks(hb, stride, e, beta, scale3(bxdf, inv_pdf), row * 8 + lobe,
                ca, cb, ln);
    beta = V3{beta.x * bxdf.x * inv_pdf, beta.y * bxdf.y * inv_pdf,
              beta.z * bxdf.z * inv_pdf};
    p = hp;
    d = norm3(new_dir, 1e-30f);
  }

  // Reverse beta-chain: A_j = e_j + w_j * A_{j+1}; the lobe's colours get
  // beta_j * A_{j+1} times its coefficients.
  V3 a = zero;
  for (int b = stored - 1; b >= 0; --b) {
    const float* hb = hk + (size_t)b * P.n;
    const V3 e = V3{hb[H_E * stride], hb[(H_E + 1) * stride],
                    hb[(H_E + 2) * stride]};
    const V3 wj = V3{hb[H_W * stride], hb[(H_W + 1) * stride],
                     hb[(H_W + 2) * stride]};
    const int code = (int)hb[H_CODE * stride];
    const int lobe = code % 8;
    if (lobe) {
      const V3 bj = V3{hb[H_BETA * stride], hb[(H_BETA + 1) * stride],
                       hb[(H_BETA + 2) * stride]};
      const V3 ctw = mul3(bj, a);
      const float ca = hb[H_CA * stride];
      const int gr = (code / 8) * G_ROW;
      if (lobe == 1) {
        g.add3(gr + G_REFR, scale3(ctw, ca));
      } else if (lobe == 2) {
        g.add3(gr + G_REFR, scale3(ctw, ca));
        g.add3(gr + G_REFL, scale3(ctw, hb[H_CB * stride]));
      } else if (lobe == 3) {
        g.add3(gr + G_SPEC, scale3(ctw, ca));
        g.add(gr + G_GLOSS, dot3(ctw, wj) * hb[H_LN * stride]);
      } else {
        g.add3(gr + G_DIFF, scale3(ctw, ca));
      }
    }
    a = add3(e, mul3(wj, a));
  }

  if (P.work) {
    int* row = P.work + 4 * (size_t)lane;
    row[0] = w.tests;
    row[1] = w.ciphers;
    row[2] = w.vertices;
    row[3] = w.tri_tests;
  }
}

// Without the mesh 4 blocks an SM hold their registers; the mesh's walk
// takes more registers, and at 128 (4 blocks) it spills more than at 3.
template <bool kMesh>
__global__ void __launch_bounds__(kThreads, kMesh ? 3 : 4)
    adjoint_kernel(const WithMesh<Params, kMesh> P) {
  QR_SHARED_FLOATS(smem);
  // The block's [n_params][kThreads] sums, then the scene tables. Thread t
  // owns column t (the host build's blocks of one thread use column 0).
  float* sums = smem;
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < P.n_params * kThreads; i += nt) sums[i] = 0.0f;
  const Shared S =
      stage_tables(P, MTL_COLS, smem + P.n_params * kThreads);
  const int lane = blockIdx.x * nt + t;
  if (lane < P.n) adjoint_lane(P, S, Sums{sums + t}, lane);
  __syncthreads();
  // The columns fold in a fixed order, a tree: column c + m onto column c
  // for m = 64, 32, ..., 1. Then one row a block (the host build, one lane
  // a block by default, folds its blocks onto the rows in lane order).
  for (int s = kLogThreads - 1; s >= 0; --s) {
    for (int i = t; i < P.n_params << s; i += nt) {
      float* c = sums + (i >> s) * kThreads + (i & ((1 << s) - 1));
      c[0] += c[1 << s];
    }
    __syncthreads();
  }
  float* out = P.out + (size_t)(blockIdx.x % P.n_rows) * P.n_params;
  for (int k = t; k < P.n_params; k += nt) out[k] += sums[k * kThreads];
}

// The instantiation with the world mesh compiled in or out.
template <bool kMesh>
int launch(const Params& P, size_t smem, void* stream) {
  using PM = WithMesh<Params, kMesh>;
  void (*const kernel)(const PM) = adjoint_kernel<kMesh>;
  if (smem > 48 * 1024) {
    const int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  QR_LAUNCH(kernel, P.n_rows, kThreads, smem, stream, PM{P});
  return (int)cudaGetLastError();
}

// Bytes of a block's shared memory: kThreads columns of the n_params
// sums, then the scene tables.
size_t block_smem(int num_prims, int num_mtls, int num_lights) {
  return 4 * (size_t)kThreads * (G_ROW * num_mtls + 3 * num_lights + 6) +
         table_bytes(num_prims, num_mtls, MTL_COLS, num_lights);
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError(). n > 0 is the caller's job; out is [n_rows, n_params]
// with n_rows = ceil(n / 128), zeroed; hooks [13, max_bounce + 1, n]. The
// sums have a fixed order: two launches on the same inputs give the same
// bits.
extern "C" int qr_adjoint_render(
    const int* px, const int* py, const int* sid, int n, const float* prim,
    const int* kinds, const int* prim_mtl, int num_prims, const float* mtl,
    int num_mtls, const float* light, const int* lkind, const int* lsoft,
    int num_lights, float light_norm, const float* cam, uint32_t key0,
    uint32_t key1, int width, int max_bounce, int shadow_spp,
    int shadow_spp_max, const float* mrows, const float* mattr,
    const float* mtree, int n_leaves, int leaf_rows, const float* ct,
    float* hooks, float* out, int n_rows, int n_params, int* work,
    void* stream) {
  if (num_mtls > MAX_ROWS || num_lights > MAX_LIGHTS ||
      n_params != G_ROW * num_mtls + 3 * num_lights + 6 ||
      n_rows != (n + kThreads - 1) / kThreads || max_bounce < 0)
    return (int)cudaErrorInvalidValue;
  Params P{px, py, sid, n, prim, kinds, prim_mtl, num_prims, mtl, num_mtls,
           light, lkind, lsoft, num_lights, light_norm, cam, key0, key1,
           width, max_bounce, shadow_spp, shadow_spp_max,
           reinterpret_cast<const float4*>(mrows),
           reinterpret_cast<const float4*>(mattr), mtree, n_leaves,
           leaf_rows, ct, hooks, out, n_rows, n_params, work};
  const size_t smem = block_smem(num_prims, num_mtls, num_lights);
  return n_leaves > 0 ? launch<true>(P, smem, stream)
                      : launch<false>(P, smem, stream);
}

// Bytes of a block's shared memory (ops/adjoint.block_smem_bytes, which the
// CPU tests hold to this).
extern "C" int qr_adjoint_smem_bytes(int num_prims, int num_mtls,
                                     int num_lights) {
  return (int)block_smem(num_prims, num_mtls, num_lights);
}

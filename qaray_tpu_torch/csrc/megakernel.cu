// Path-trace megakernel (K1a, with K1b, K1c and K1d): one whole pathtrace or
// photonmap sample per thread, camera ray to radiance, in one launch.
//
// Replaces the Pallas TPU kernel qaray_tpu/ops/pallas_pathtrace.py
// ::_make_kernel (dispatched by _mega_raw), with its helpers _closest_hit,
// _shadow_occluded, _illuminate, _blinn_direct, _glossy_jitter, _halton and
// the in-kernel threefry of core/krng.py (K1a), and its world-mesh sweep
// _mesh_tri_test / _cluster_overlaps / _bundle_bounds (K1c), and its checker
// textures: the winner's uv and primary-hit footprints of _closest_hit and
// _apply_checker_textures (K1b), and its photon outputs: the in-kernel
// caustics gather (photon_sweep), the irr0 and escalation planes and the
// global-map gather records (K1d).
//
// What bounds it on the H100: operations. A lane reads 12 bytes and
// writes 16, but does per bounce a closest-hit sweep over the primitives,
// a threefry cipher per random draw (about 120 integer operations each),
// and for every soft light 16 to 64 shadow rays, each one cipher plus a
// sweep. The work per lane varies with its path (roulette, escalation),
// so threads of a warp diverge. The design answers with what the TPU
// kernel could not do: one thread per lane with scalar control flow, dead
// paths leave the bounce loop, shadow rays stop at their first occluder,
// lanes that do not escalate skip the soft-shadow tail, and only the lobe a
// path takes computes its direction. The scene tables (12 floats a
// primitive, 22 a material, 12 a light, 25 for the camera) are staged in
// shared memory once per block. Specialisation on scene facts is by
// per-primitive and per-light kind tables read at run time, uniform across
// a warp; the sum over lights keeps blinn_direct's order.
//
// K1c, the mesh sweep: world-baked triangles in Morton order, 256 to a
// cluster with an AABB each (scene/compiler.py, build_mega_mesh). Inside
// the bounce loop each thread walks the clusters in order, culls each one
// against its own ray (mesh.cuh's widened slab test; the Pallas kernel
// bounds a whole ray block instead) below its current best t, and sweeps
// the survivors' rows with the predicate K3 uses, folding t, the smooth
// normal a*n0 + b*n1 + c*n2 from the attribute table, the front flag and
// the material row. Shadow rays stop at the first occluder. The tables
// stay in global memory, read through the read-only path: a lane's rows
// are the same as its warp neighbours' (coherent rays cull alike), so they
// come from L1. Bounded by operations too: about 40 per triangle test,
// counted per lane in `work`.
//
// K1b, checker textures: the kernel is compiled twice, mega_kernel<false>
// for untextured scenes (K1a as it was, no texture code in it) and
// mega_kernel<true> for scenes whose live material textures are all
// procedural checkers. There the material rows carry 16 more columns per
// slot (102 in all, still in shared memory), the closest-hit fold keeps the
// winner's uv (atan2f/asinf, as K2b and the engine compute it), and at the
// primary hit two differential camera rays are intersected with the
// winner's local tangent plane for the footprint duv0, duv1. A textured
// slot's colour is multiplied by w*color1 + (1-w)*color2, w the checker test
// at the transformed uv, or at the primary hit the mean of that test over
// the centre and the 31 elliptic offsets of ops/texture.py, which the
// wrapper uploads to constant memory. The loop over the offsets stays a
// loop (registers). The transform and the sample positions keep the plain
// version's operation order: a checker flips at frac == 0.5, so a last-bit
// difference would change a whole colour. Mesh winners carry no uv; their
// rows have no texture (the compiler refuses such scenes for this route).
// Operations again: 32 checker tests a textured slot at a primary vertex,
// one at a later vertex, counted in `work`.
//
// K1d, photon gathering (photonmap with -use-photon-map): a third
// instantiation flag, mega_kernel<kTex, true>, so scenes without maps run
// the kernels they ran before. At every diffuse-selected vertex the lane
// sweeps the caustics map for its own hit point (photon.cuh's per-thread
// sweep: lanes are not spatially sorted, so each culls the map's clusters
// against its own point, and reads the rows, 64 KB at the default 1,000
// photons, through the read-only cache), Blinn-combines the estimate with
// gather_blinn's luma gate and adds it, and raises the lane's escalation
// flag where more than GATHER_K (100) photons lay in the radius: there the
// estimate needs the radius cap, which the Renderer gets by rendering the
// lane again on the wavefront engine. A diffuse-selected vertex after a
// diffuse bounce also gathers the global map; the path ends there, so a
// lane has at most one such vertex, and the kernel writes that vertex's
// 17-field record (p, n, v, beta*diffuse, beta*specular, glossiness,
// valid) straight to its output planes instead of sweeping the global map
// from incoherent lanes: the wrapper Morton-sorts the records and gathers
// them with K5 (ops/photon.gather_apply). The primary vertex's irr0 flag
// (a photon surface) is the fb debug plane. Output planes are zeroed by
// the wrapper; the kernel writes only the ones a lane sets. Operations
// again: about 20 a photon test, counted with the cluster tests in the
// last two columns of `work`.
//
// Random draws are bit-exact with jax.random (threefry2x32 key words):
// the per-lane key is fold(base, rid * 65536 + sid) in wrapping 32-bit
// arithmetic, then fold(1000 + bounce) and a purpose tag per decision, as
// in the wavefront engine. The device code the fused adjoint (K6,
// adjoint.cu) replays these paths with lives in mega_common.cuh.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mega_common.cuh"
#include "photon.cuh"

// The launch and the block's dynamic shared memory go through two macros,
// so that the CPU tests can compile this source with g++ against
// csrc/host/cuda_runtime.h, which defines them otherwise, and run it one
// lane at a time beside the plain version (ops/_build.load_host).
#ifndef QR_LAUNCH
#define QR_SHARED_FLOATS(name) extern __shared__ float name[]
#define QR_LAUNCH(kernel, blocks, threads, smem, stream, arg) \
  kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(arg)
#endif

namespace {

// Checker columns (_MT_TEXBASE layout): 16 per slot from column 22, slots
// diffuse, specular, emission, reflection, refraction.
constexpr int MT_TEXBASE = 22, TEX_STRIDE = 16, TEX_HAS = 0, TEX_C1 = 1,
              TEX_C2 = 4, TEX_M0 = 7, TEX_M1 = 10, TEX_T = 13, NUM_SLOTS = 5;
constexpr int TEX_OFFSETS = 31;  // TEXTURE_SAMPLE_COUNT - 1
constexpr float RCP_DIFF = 100.0f;  // RCP_DX = RCP_DY = 1 / 0.01
constexpr float DIFF_D = 0.01f;     // DIFF_DX = DIFF_DY
constexpr float CLT = 0.00001f;  // COLOR_LUMA_THRESHOLD
constexpr float GATHER_K = 100.0f;  // photon/cluster.py
constexpr int NUM_REC = 17;        // fields of a global-map gather record
constexpr int kThreads = 128;

// The 31 elliptic footprint offsets (ops/texture.elliptic_offsets_np),
// uploaded once by qr_mega_set_tex_offsets.
__constant__ float c_tex_xs[TEX_OFFSETS];
__constant__ float c_tex_ys[TEX_OFFSETS];

struct Params {
  const int* px;
  const int* py;
  const int* sid;
  int n;
  const float* prim;
  const int* kinds;
  const int* prim_mtl;
  int num_prims;
  const float* mtl;
  int num_mtls;
  int mtl_cols;  // 22, or 102 with the checker columns
  int tex_mask;  // bit s: material slot s carries a live checker somewhere
  const float* light;
  const int* lkind;
  const int* lsoft;
  int num_lights;
  float light_norm;  // (1 / num_lights) ^ norm_power
  const float* cam;
  uint32_t key0, key1;
  int width;
  int photonmap;  // 0 pathtrace, 1 photonmap
  int max_bounce;
  int shadow_spp, shadow_spp_max;
  int has_dof, has_glossy;
  const float4* mrows;  // [Fp, 16] mesh sweep coefficients (Morton order)
  const float4* mattr;  // [Fp, 16] corner normals (0-8), material row (9)
  const float* mcb;     // [C, 8] cluster AABBs
  int n_clusters;       // 0: no mesh
  float* r;
  float* g;
  float* b;
  float* t0;
  int* work;  // optional [n, 7]: prim tests, ciphers, vertices, tri tests,
              // checker tests; K1d: photon tests, caustics cluster tests
  // K1d: the clustered caustics map ([Fc, 16] rows, [C, 8] boxes), its
  // squared radius, and the [19, n] outputs (irr0, esc, 17 record planes).
  const float4* ctab;
  const float* ccb;
  int n_cclusters;
  float cr2;
  float* pout;
};

__device__ __forceinline__ float luma3(V3 c) {
  return 0.2126f * c.x + 0.7152f * c.y + 0.0722f * c.z;
}

// blinn_direct with skip_ambient, lights summed in table order.
__device__ V3 blinn_direct(const Params& P, const Shared& S, V3 p, V3 n,
                           V3 v, V3 diffuse, V3 specular, float gloss,
                           Key kb, Work& w) {
  V3 total = V3{0.0f, 0.0f, 0.0f};
  for (int li = 0; li < P.num_lights; ++li) {
    const int kind = S.lkind[li];
    if (kind == LIGHT_AMBIENT) continue;
    const V3 inten =
        scale3(illuminate(P, S, li, p, kb, w), P.light_norm);
    const float* lt = S.light + li * LIGHT_COLS;
    V3 l_dir;
    if (kind == LIGHT_DIRECT) {
      l_dir = norm3(neg3(load3(lt + LT_DIR)), 1e-30f);
    } else {
      const V3 to_p = norm3(sub3(p, load3(lt + LT_POS)), 1e-30f);
      l_dir = norm3(neg3(to_p), 1e-30f);
    }
    const V3 h = norm3(add3(v, l_dir), 1e-30f);
    const float cos_nl = fmaxf(0.0f, dot3(n, l_dir));
    const float cos_nh = fmaxf(0.0f, dot3(n, h));
    const float spec_w = pow_safe(cos_nh, gloss);
    const V3 spec = scale3(specular, spec_w);
    total = V3{total.x + inten.x * cos_nl * (diffuse.x + spec.x),
               total.y + inten.y * cos_nl * (diffuse.y + spec.y),
               total.z + inten.z * cos_nl * (diffuse.z + spec.z)};
  }
  return total;
}

// Glossy rejection jitter (pallas_pathtrace._glossy_jitter): 4 hemisphere
// attempts of a 4-attempt quirk ball, first success wins, centre fallback.
// Attempt (a, i) draws flat elements 8a + 2i and 8a + 2i + 1.
__device__ V3 glossy_jitter(V3 center, V3 y_axis, float gloss, Key k,
                            bool want_up, Work& w) {
  const V3 c = norm3(center, 1e-30f);
  const float radius = 2.0f * gloss;
  for (int a = 0; a < 4; ++a) {
    V3 pick;
    for (int i = 0; i < 4; ++i) {
      const uint32_t f = (uint32_t)(a * 8 + i * 2);
      const float r1 = draw_w(k, f, w) * 2.0f - 1.0f;
      const float r2 = draw_w(k, f + 1, w) * 2.0f - 1.0f;
      pick = V3{r1, r2, r2};
      if (sqrtf(dot3(pick, pick)) <= 1.0f) break;
    }
    const V3 cand = norm3(add3(c, clamp_ball(pick, radius)), 1e-30f);
    const float side = dot3(cand, y_axis);
    if (want_up ? side >= 0.0f : side <= 0.0f) return cand;
  }
  return c;
}

// uv where the differential ray (p, dd) meets the winner's local plane
// through `anchor` with normal n_loc, in the primitive's object space
// (ops/intersect.analytic_diff_uv's offset_uv; objects.cpp:107-135,
// 174-202). Spheres: the asin is corrected by the point's radius.
__device__ __forceinline__ void offset_uv(const float* pr, int kind, V3 p,
                                          V3 dd, V3 n_loc, V3 anchor,
                                          float& uo, float& vo) {
  V3 po, dobj;
  obj_ray(pr, p, dd, po, dobj);
  float den = dot3(dobj, n_loc);
  if (fabsf(den) < 1e-20f) den = 1e-20f;
  const float t_off = -dot3(sub3(po, anchor), n_loc) / den;
  const V3 hpo = add3(po, scale3(dobj, t_off));
  if (kind == QR_KIND_SPHERE) {
    const float r = sqrtf(fmaxf(dot3(hpo, hpo), 1e-30f));
    uo = 0.5f - atan2f(hpo.x, hpo.y) / (float)(2.0 * M_PI);
    vo = 0.5f + asinf(fminf(fmaxf(hpo.z / r, -1.0f), 1.0f)) / (float)M_PI;
  } else {
    uo = (hpo.x + 1.0f) * 0.5f;
    vo = (hpo.y + 1.0f) * 0.5f;
  }
}

// TextureChecker::Sample as a weight: 1 takes color1, 0 color2.
__device__ __forceinline__ float checker01(float u, float v) {
  const float ut = u - floorf(u);
  const float vt = v - floorf(v);
  return ((ut <= 0.5f) == (vt <= 0.5f)) ? 1.0f : 0.0f;
}

// TexturedColor::Sample of one material slot (K1b;
// pallas_pathtrace._apply_checker_textures). tx: the slot's 16 columns;
// (u, v): the winner's texture coordinates; filter: a primary hit, whose
// footprint (du0, dv0), (du1, dv1) is averaged over 32 samples unless zero.
__device__ V3 textured(const float* tx, V3 color, float u, float v,
                       bool filter, float du0, float dv0, float du1,
                       float dv1, Work& w) {
  if (!(tx[TEX_HAS] > 0.5f)) return color;
  const float* m0 = tx + TEX_M0;
  const float* m1 = tx + TEX_M1;
  const float pu = u - tx[TEX_T], pv = v - tx[TEX_T + 1],
              pw = 0.0f - tx[TEX_T + 2];
  const float um = m0[0] * pu + m0[1] * pv + m0[2] * pw;
  const float vm = m1[0] * pu + m1[1] * pv + m1[2] * pw;
  float w1 = checker01(um, vm);
  ++w.checkers;
  if (filter && (du0 * du0 + dv0 * dv0 + du1 * du1 + dv1 * dv1) != 0.0f) {
    const float d0u = m0[0] * du0 + m0[1] * dv0;
    const float d0v = m1[0] * du0 + m1[1] * dv0;
    const float d1u = m0[0] * du1 + m0[1] * dv1;
    const float d1v = m1[0] * du1 + m1[1] * dv1;
    float acc = w1;
#pragma unroll 1
    for (int i = 0; i < TEX_OFFSETS; ++i) {
      const float xs = c_tex_xs[i], ys = c_tex_ys[i];
      acc = acc + checker01(um + xs * d0u + ys * d1u, vm + xs * d0v + ys * d1v);
    }
    w1 = acc * (1.0f / 32.0f);
    w.checkers += TEX_OFFSETS;
  }
  const float w2 = 1.0f - w1;
  return V3{color.x * (w1 * tx[TEX_C1] + w2 * tx[TEX_C2]),
            color.y * (w1 * tx[TEX_C1 + 1] + w2 * tx[TEX_C2 + 1]),
            color.z * (w1 * tx[TEX_C1 + 2] + w2 * tx[TEX_C2 + 2])};
}

// kTex: the scene has checker textures (K1b); material rows are then
// P.mtl_cols wide, MTL_COLS otherwise. kPhoton: photon gathering (K1d).
template <bool kTex, bool kPhoton>
__global__ void __launch_bounds__(kThreads)
    mega_kernel(const Params P) {
  QR_SHARED_FLOATS(smem);
  const int mtl_cols = kTex ? P.mtl_cols : MTL_COLS;
  const Shared S = stage_tables(P, mtl_cols, smem);
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= P.n) return;
  Work w{0, 0, 0, 0, 0, 0, 0};

  const int px = P.px[lane], py = P.py[lane], sid = P.sid[lane];
  const uint32_t rid = (uint32_t)py * (uint32_t)P.width + (uint32_t)px;
  const Key kr =
      fold_w(Key{P.key0, P.key1}, rid * 65536u + (uint32_t)sid, w);

  // Camera ray (renderer.cpp:302-327; Halton 11/13 sub-pixel jitter).
  const float tx = (float)px + halton(sid, 11);
  const float ty = (float)py + halton(sid, 13);
  const V3 ca = load3(S.cam + CAM_A), cu = load3(S.cam + CAM_U),
           cv = load3(S.cam + CAM_V);
  const V3 cpt = V3{ca.x + tx * cu.x + ty * cv.x, ca.y + tx * cu.y + ty * cv.y,
                    ca.z + tx * cu.z + ty * cv.z};
  V3 p = load3(S.cam + CAM_POS);
  if (P.has_dof) {
    const Key kd = fold_w(kr, P_DOF, w);
    const float lr = S.cam[CAM_DOF] * sqrtf(draw_w(kd, 0, w));
    const float lt = TWO_PI * draw_w(kd, 1, w);
    const float lx = lr * cosf(lt), ly = lr * sinf(lt);
    const V3 cx = load3(S.cam + CAM_X), cy = load3(S.cam + CAM_Y);
    p = V3{p.x + lx * cx.x + ly * cy.x, p.y + lx * cx.y + ly * cy.y,
           p.z + lx * cx.z + ly * cy.z};
  }
  V3 d = norm3(sub3(cpt, p));
  // Differential camera rays through the screen points DIFF_D pixels right
  // of and below the sample (DiffRay ctor, renderer.cpp:314-326): they give
  // the primary hit's texture footprint.
  V3 dxd = V3{0.0f, 0.0f, 0.0f}, dyd = V3{0.0f, 0.0f, 0.0f};
  if (kTex) {
    const V3 xpt = V3{cpt.x + DIFF_D * cu.x, cpt.y + DIFF_D * cu.y,
                      cpt.z + DIFF_D * cu.z};
    const V3 ypt = V3{cpt.x + DIFF_D * cv.x, cpt.y + DIFF_D * cv.y,
                      cpt.z + DIFF_D * cv.z};
    dxd = norm3(sub3(xpt, p));
    dyd = norm3(sub3(ypt, p));
  }

  V3 radiance = V3{0.0f, 0.0f, 0.0f};
  V3 beta = V3{1.0f, 1.0f, 1.0f};
  float t0 = QR_BIGFLOAT;
  bool has_dh = false;                  // photonmap hasDiffuseHit
  V3 pend = V3{0.0f, 0.0f, 0.0f};       // parent's absorption

  for (int bounce = 0; bounce <= P.max_bounce; ++bounce) {
    Hit hit = closest_hit<kTex>(S.prim, S.kinds, P.num_prims, p, d);
    w.tests += P.num_prims;
    int mesh_row = -1;
    if (P.n_clusters > 0) mesh_closest(P, p, d, hit, &mesh_row, w);
    const bool is_hit = hit.t < QR_BIGFLOAT;
    if (bounce == 0) t0 = is_hit ? hit.t : QR_BIGFLOAT;
    if (!is_hit) {
      const V3 mc = load3(S.cam + (bounce == 0 ? CAM_BG : CAM_ENV));
      radiance = add3(radiance, mul3(beta, mc));
      break;
    }
    ++w.vertices;
    if (P.photonmap && !hit.front) {
      // Beer attenuation on back-face continuations with the parent
      // vertex's absorption over the traveled distance.
      beta = V3{beta.x * expf(-pend.x * hit.t), beta.y * expf(-pend.y * hit.t),
                beta.z * expf(-pend.z * hit.t)};
    }
    const int row = mesh_row >= 0 ? mesh_row : S.prim_mtl[hit.prim];
    const float* mrow = S.mtl + row * mtl_cols;
    V3 diffuse = load3(mrow + MT_DIFF), specular = load3(mrow + MT_SPEC);
    V3 emit = load3(mrow + MT_EMIT), t_k = load3(mrow + MT_REFR),
       r_k = load3(mrow + MT_REFL);
    if (kTex) {
      // K1b: the primary hit's footprint from the differential rays, on an
      // analytic winner (mesh rows carry no texture), then the slots.
      const bool primary = bounce == 0;
      float du0 = 0.0f, dv0 = 0.0f, du1 = 0.0f, dv1 = 0.0f;
      if (primary && mesh_row < 0) {
        const float* pr = S.prim + hit.prim * QR_PRIM_COLS;
        const int kind = S.kinds[hit.prim];
        V3 po, dobj;
        obj_ray(pr, p, d, po, dobj);
        const V3 hpo = add3(po, scale3(dobj, hit.t));
        const bool sphere = kind == QR_KIND_SPHERE;
        const V3 n_loc = sphere ? norm3(hpo, 1e-30f) : V3{0.0f, 0.0f, 1.0f};
        const V3 anchor = sphere ? hpo : V3{0.0f, 0.0f, 0.0f};
        float uo, vo;
        offset_uv(pr, kind, p, dxd, n_loc, anchor, uo, vo);
        du0 = RCP_DIFF * (uo - hit.u);
        dv0 = RCP_DIFF * (vo - hit.v);
        offset_uv(pr, kind, p, dyd, n_loc, anchor, uo, vo);
        du1 = RCP_DIFF * (uo - hit.u);
        dv1 = RCP_DIFF * (vo - hit.v);
      }
      const float* tx = mrow + MT_TEXBASE;
      if (P.tex_mask & 1)
        diffuse = textured(tx, diffuse, hit.u, hit.v, primary, du0, dv0, du1,
                           dv1, w);
      if (P.tex_mask & 2)
        specular = textured(tx + TEX_STRIDE, specular, hit.u, hit.v, primary,
                            du0, dv0, du1, dv1, w);
      if (P.tex_mask & 4)
        emit = textured(tx + 2 * TEX_STRIDE, emit, hit.u, hit.v, primary, du0,
                        dv0, du1, dv1, w);
      if (P.tex_mask & 8)
        r_k = textured(tx + 3 * TEX_STRIDE, r_k, hit.u, hit.v, primary, du0,
                       dv0, du1, dv1, w);
      if (P.tex_mask & 16)
        t_k = textured(tx + 4 * TEX_STRIDE, t_k, hit.u, hit.v, primary, du0,
                       dv0, du1, dv1, w);
    }
    const float gloss = mrow[MT_GLOSS], rgloss = mrow[MT_RGLOSS],
                tgloss = mrow[MT_TGLOSS], ior = mrow[MT_IOR];
    const V3 hp = add3(p, scale3(d, hit.t));
    const V3 n = norm3(hit.n, 1e-30f);
    const bool front = hit.front;
    const V3 v = neg3(d);
    const Key kb = fold_w(kr, (uint32_t)(1000 + bounce), w);

    // Fresnel (MtlBlinn_PhotonMap::ComputeFresnel, shared by both models).
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
    const float t_ratio = 1.0f - r_ratio;
    const V3 samp_refr =
        total_refl ? V3{0.0f, 0.0f, 0.0f} : scale3(t_k, t_ratio);
    const V3 samp_refl =
        total_refl ? add3(r_k, t_k) : add3(r_k, scale3(t_k, r_ratio));
    const float select =
        draw_w(fold_w(kb, P_LOBE_SELECT, w), 0, w);

    // Lobe select.
    float c_refr = 0.f, c_refl = 0.f, c_spec = 0.f, c_diff = 0.f;
    bool sel_refr = false, sel_refl = false, sel_spec = false,
         sel_diff = false;
    float luma_t = 0.f, luma_r = 0.f, luma_d = 0.f;
    if (!P.photonmap) {
      // colorMax roulette with pdf division (MtlBlinn_PathTracing.cpp).
      const float coef_refr = max3(samp_refr), coef_refl = max3(samp_refl),
                  coef_spec = max3(specular), coef_diff = max3(diffuse);
      const float coef_sum =
          fmaxf(coef_refr + coef_refl + coef_spec + coef_diff, 1e-20f);
      c_refr = coef_refr / coef_sum;
      c_refl = coef_refl / coef_sum;
      c_spec = coef_spec / coef_sum;
      c_diff = coef_diff / coef_sum;
      const float sum_refl = c_refr + c_refl;
      const float sum_spec = sum_refl + c_spec;
      sel_refr = (select <= c_refr) && (c_refr > 1e-6f);
      sel_refl = !sel_refr && (select < sum_refl) && (c_refl > 1e-6f);
      sel_spec = !sel_refr && !sel_refl && (select < sum_spec) &&
                 (c_spec > 1e-6f);
      sel_diff = !sel_refr && !sel_refl && !sel_spec && (c_diff > 1e-6f);
    } else {
      // Luma roulette with kill = 0.1, probability not divided out
      // (RandomSelectMtl, MtlBlinn_PhotonMap.cpp:107-150).
      luma_t = luma3(samp_refr);
      luma_r = luma3(samp_refl);
      luma_d = luma3(diffuse);
      const float coef_t = luma_t;
      const float coef_r = coef_t + luma_r;
      const float coef_d = coef_r + luma_d;
      const float sel_pt = select * (coef_d + 0.1f);
      sel_refr = (sel_pt < coef_t) && (luma_t > CLT);
      sel_refl = !sel_refr && (sel_pt < coef_r) && (luma_r > CLT);
      sel_diff = !sel_refr && !sel_refl && (sel_pt < coef_d) && (luma_d > CLT);
    }

    // Emission + direct light.
    const V3 direct = blinn_direct(P, S, hp, n, v, diffuse, specular, gloss,
                                   kb, w);
    radiance = add3(radiance, mul3(beta, add3(emit, direct)));

    if (kPhoton) {
      // K1d (MtlBlinn_PhotonMap.cpp:344-368, 420-458): diffuse-selected
      // vertices gather the caustics map; those after a diffuse bounce also
      // the global map, through their record.
      const size_t np = (size_t)P.n;
      if (bounce == 0 && luma3(diffuse) > 0.0f) P.pout[lane] = 1.0f;
      if (sel_diff) {
        if (has_dh) {
          const float rec[NUM_REC] = {
              hp.x, hp.y, hp.z, n.x, n.y, n.z, v.x, v.y, v.z,
              beta.x * diffuse.x, beta.y * diffuse.y, beta.z * diffuse.z,
              beta.x * specular.x, beta.y * specular.y, beta.z * specular.z,
              gloss, 1.0f};
          for (int k = 0; k < NUM_REC; ++k)
            P.pout[(2 + k) * np + lane] = rec[k];
        }
        const float cr = sqrtf(P.cr2);
        const PhotonSums s =
            photon_sweep_thread(P.ctab, P.ccb, P.n_cclusters, hp, cr, P.cr2,
                                1.0f / P.cr2, &w.pclusters, &w.photons);
        const float inv_area = 1.0f / ((float)(M_PI * 0.5) * P.cr2);
        const V3 irrad = V3{s.ir * inv_area, s.ig * inv_area, s.ib * inv_area};
        // gather_blinn: L = -normalize(dir), H = normalize(V + L),
        // I * cosNL * (diffuse + specular * cosNH^gloss), under the luma gate.
        const V3 l_dir = neg3(norm3(V3{s.dx, s.dy, s.dz}, 1e-30f));
        const V3 hh = norm3(add3(v, l_dir), 1e-30f);
        const float cos_nl = fmaxf(0.0f, dot3(n, l_dir));
        const float cos_nh = fmaxf(0.0f, dot3(n, hh));
        const float spec_w = pow_safe(cos_nh, gloss);
        if (luma3(irrad) > CLT) {
          radiance = V3{
              radiance.x + beta.x * (irrad.x * cos_nl *
                                     (diffuse.x + specular.x * spec_w)),
              radiance.y + beta.y * (irrad.y * cos_nl *
                                     (diffuse.y + specular.y * spec_w)),
              radiance.z + beta.z * (irrad.z * cos_nl *
                                     (diffuse.z + specular.z * spec_w))};
        }
        if (s.cnt > GATHER_K) P.pout[np + lane] = 1.0f;
      }
    }
    if (bounce == P.max_bounce) break;

    const V3 t_dir = V3{-x.x * sin_o - y.x * cos_o, -x.y * sin_o - y.y * cos_o,
                        -x.z * sin_o - y.z * cos_o};
    const V3 r_dir = V3{2.0f * n.x * cos_nv - v.x, 2.0f * n.y * cos_nv - v.y,
                        2.0f * n.z * cos_nv - v.z};
    V3 new_dir;
    if (!P.photonmap) {
      // Continuation (MtlBlinn_PathTracing.cpp:176-297).
      const bool go_spec = sel_spec && front;
      const bool go_diff = sel_diff && front;
      if (!(sel_refr || sel_refl || go_spec || go_diff)) break;
      const Key kh = fold_w(kb, P_LOBE_SAMPLE, w);
      const float u0 = draw_w(kh, 0, w), u1 = draw_w(kh, 1, w);
      const float ct = sqrtf(u0);
      const float st = sqrtf(fmaxf(0.0f, 1.0f - u0));
      const float phi = TWO_PI * u1;
      const V3 hemi = norm3(V3{st * cosf(phi), st * sinf(phi), ct}, 1e-30f);
      const V3 hemi_world = to_local_frame(y, hemi);
      V3 bxdf;
      float pdf;
      if (sel_refr) {
        const bool glossy = tgloss > 0.0f;
        new_dir = glossy ? neg3(hemi_world) : t_dir;
        bxdf = glossy ? scale3(samp_refr,
                               pow_safe(fmaxf(0.0f, dot3(v, t_dir)), tgloss))
                      : samp_refr;
        pdf = c_refr;
      } else if (sel_refl) {
        const bool glossy = rgloss > 0.0f;
        new_dir = glossy ? hemi_world : r_dir;
        bxdf = glossy ? scale3(samp_refl,
                               pow_safe(fmaxf(0.0f, dot3(v, r_dir)), rgloss))
                      : samp_refl;
        pdf = c_refl;
      } else if (go_spec) {
        const V3 h = norm3(add3(v, norm3(hemi_world, 1e-30f)), 1e-30f);
        new_dir = hemi_world;
        bxdf = scale3(specular, pow_safe(fmaxf(0.0f, dot3(n, h)), gloss));
        pdf = c_spec;
      } else {
        new_dir = hemi_world;
        bxdf = diffuse;
        pdf = c_diff;
      }
      const float inv_pdf = 1.0f / fmaxf(pdf, 1e-20f);
      beta = V3{beta.x * bxdf.x * inv_pdf, beta.y * bxdf.y * inv_pdf,
                beta.z * bxdf.z * inv_pdf};
    } else {
      // Continuation (MtlBlinn_PhotonMap::Sample*BxDF + ComputeSecondaryRay,
      // MtlBlinn_PhotonMap.cpp:152-254).
      const bool go_transmit = sel_refr;
      const bool go_reflect = sel_refl;
      const bool go_diffuse = sel_diff && !has_dh && front;
      if (!(go_reflect || go_transmit || go_diffuse)) break;
      const Key ks2 = fold_w(kb, P_LOBE_SAMPLE, w);
      V3 weight;
      if (go_transmit) {
        new_dir = (P.has_glossy && tgloss > 0.0f)
                      ? glossy_jitter(t_dir, y, tgloss, fold_w(ks2, 12, w),
                                      false, w)
                      : t_dir;
        weight = samp_refr;
      } else if (go_diffuse) {
        const Key kd2 = fold_w(ks2, 13, w);
        const float u0 = draw_w(kd2, 0, w), u1 = draw_w(kd2, 1, w);
        const float ct = sqrtf(u0);
        const float st = sqrtf(fmaxf(0.0f, 1.0f - u0));
        const float phi = TWO_PI * u1;
        new_dir = to_local_frame(n, V3{st * cosf(phi), st * sinf(phi), ct});
        const V3 h = norm3(add3(v, norm3(new_dir, 1e-30f)), 1e-30f);
        const float ws = pow_safe(fmaxf(0.0f, dot3(n, h)), gloss);
        weight = add3(diffuse, scale3(specular, ws));
      } else {
        new_dir = (P.has_glossy && rgloss > 0.0f)
                      ? glossy_jitter(r_dir, y, rgloss, fold_w(ks2, 11, w),
                                      true, w)
                      : r_dir;
        weight = samp_refl;
      }
      beta = mul3(beta, weight);
      has_dh = go_diffuse;
      pend = load3(mrow + MT_ABS);
    }
    p = hp;
    d = norm3(new_dir, 1e-30f);
  }

  P.r[lane] = radiance.x;
  P.g[lane] = radiance.y;
  P.b[lane] = radiance.z;
  P.t0[lane] = t0;
  if (P.work) {
    int* row = P.work + 7 * lane;
    row[0] = w.tests;
    row[1] = w.ciphers;
    row[2] = w.vertices;
    row[3] = w.tri_tests;
    row[4] = w.checkers;
    if (kPhoton) {
      row[5] = w.photons;
      row[6] = w.pclusters;
    }
  }
}

}  // namespace

// Uploads the 31 footprint offsets (host pointers) to constant memory.
extern "C" int qr_mega_set_tex_offsets(const float* xs, const float* ys) {
  int rc = (int)cudaMemcpyToSymbol(c_tex_xs, xs, sizeof(float) * TEX_OFFSETS);
  if (rc) return rc;
  return (int)cudaMemcpyToSymbol(c_tex_ys, ys, sizeof(float) * TEX_OFFSETS);
}

namespace {

template <bool kTex, bool kPhoton>
int launch(const Params& P, size_t smem, void* stream) {
  void (*const kernel)(const Params) = mega_kernel<kTex, kPhoton>;
  if (smem > 48 * 1024) {
    int rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc) return rc;
  }
  QR_LAUNCH(kernel, (P.n + kThreads - 1) / kThreads, kThreads, smem, stream,
            P);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes): launches on `stream`, returns
// cudaGetLastError(). n > 0 is the caller's job. tex_mask != 0 selects the
// textured kernel (K1b), whose material rows are mtl_cols wide; pout !=
// NULL the photon-gathering one (K1d, photonmap only), whose [19, n]
// outputs the caller has zeroed.
extern "C" int qr_mega_render(
    const int* px, const int* py, const int* sid, int n, const float* prim,
    const int* kinds, const int* prim_mtl, int num_prims, const float* mtl,
    int num_mtls, int mtl_cols, int tex_mask, const float* light,
    const int* lkind, const int* lsoft, int num_lights, float light_norm,
    const float* cam, uint32_t key0, uint32_t key1, int width, int photonmap,
    int max_bounce, int shadow_spp, int shadow_spp_max, int has_dof,
    int has_glossy, const float* mrows, const float* mattr, const float* mcb,
    int n_clusters, float* r, float* g, float* b, float* t0, int* work,
    const float* ctab, const float* ccb, int n_cclusters, float cr2,
    float* pout, void* stream) {
  if (tex_mask ? mtl_cols != MT_TEXBASE + TEX_STRIDE * NUM_SLOTS
               : mtl_cols != MTL_COLS)
    return (int)cudaErrorInvalidValue;
  if (pout && !(photonmap && ctab && ccb && n_cclusters > 0 && cr2 > 0.0f))
    return (int)cudaErrorInvalidValue;
  Params P{px, py, sid, n, prim, kinds, prim_mtl, num_prims, mtl, num_mtls,
           mtl_cols, tex_mask, light, lkind, lsoft, num_lights, light_norm,
           cam, key0, key1, width, photonmap, max_bounce, shadow_spp,
           shadow_spp_max, has_dof, has_glossy,
           reinterpret_cast<const float4*>(mrows),
           reinterpret_cast<const float4*>(mattr), mcb, n_clusters, r, g, b,
           t0, work, reinterpret_cast<const float4*>(ctab), ccb,
           n_cclusters, cr2, pout};
  const size_t smem = table_bytes(num_prims, num_mtls, mtl_cols, num_lights);
  if (pout)
    return tex_mask ? launch<true, true>(P, smem, stream)
                    : launch<false, true>(P, smem, stream);
  return tex_mask ? launch<true, false>(P, smem, stream)
                  : launch<false, false>(P, smem, stream);
}

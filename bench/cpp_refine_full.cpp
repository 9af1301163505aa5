// FULL refinement alternation baseline: single-threaded plain-C++
// implementation of the reference's complete alternating Gauss-Newton loop
// (PsOptimizer.cpp:239-428) — initAlbedo, energy-ratio reg-weight
// normalization, per-iteration {albedo, light, distance, pose} blocks with
// per-block residual refresh + energy recompute, rel-dE convergence and
// divergence abort — timed wall-clock to convergence (round-4 VERDICT #1).
//
// Block semantics are the oracle's (bench/cpp_refine_oracle.cpp, pinned
// against the JAX blocks by tests/test_refine_oracle.py):
//   * residual pass        PsOptimizerJa.cpp:567-626
//   * albedo block         PsOptimizerJa.cpp:118-129, PsOptimizer.cpp:85-121
//   * light block          PsOptimizerJa.cpp:132-157, PsOptimizer.cpp:175-203
//   * distance block       PsOptimizerJa.cpp:160-289,479-562 + Eikonal reg
//                          (Optimizer.cpp:86-103,196-218,477-537), Jacobi-PCG
//   * pose block           PsOptimizerJa.cpp:61-115, PsOptimizer.cpp:207-234
//   * updates              OptimizerAux.cpp:108-205 (clamps, step rejection,
//                          updateGrad FD refresh)
//
// Pass structure: like the JAX build's loop (refine/optimizer.py), each
// block runs ONE residual pass at the post-update state, consumed both as
// the energy input and as the next block's linearization point — HALF the
// residual passes of the literal reference (each optimize*All plus each
// getPSEnergy re-runs computeResidual there), i.e. this baseline is
// strictly STRONGER than the reference's own loop.
//
// The reference repo itself cannot be built here (empty vendored
// submodules) — this is an independent reimplementation from its sources.
//
// Usage: cpp_refine_full W H DIM F MAX_IT OUTDIR
// Dumps the INITIAL problem state (volume, image, poses, lights, meta) to
// OUTDIR so the JAX side can run the literally identical problem, then
// runs + times the loop and prints ONE JSON line.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

struct V3 { float x, y, z; };
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline float norm(V3 a) { return std::sqrt(dot(a, a)); }
static inline V3 normalized(V3 a) {            // geometry.normalize (eps 1e-12)
    float n = std::max(norm(a), 1e-12f);
    return mul(a, 1.f / n);
}

struct Mat3 { float m[9]; };
static inline V3 mv(const Mat3 &R, V3 p) {
    return {R.m[0] * p.x + R.m[1] * p.y + R.m[2] * p.z,
            R.m[3] * p.x + R.m[4] * p.y + R.m[5] * p.z,
            R.m[6] * p.x + R.m[7] * p.y + R.m[8] * p.z};
}
static inline V3 mtv(const Mat3 &R, V3 p) {
    return {R.m[0] * p.x + R.m[3] * p.y + R.m[6] * p.z,
            R.m[1] * p.x + R.m[4] * p.y + R.m[7] * p.z,
            R.m[2] * p.x + R.m[5] * p.y + R.m[8] * p.z};
}

int W, H, DIM, F, MAX_IT;
float fx, fy, cx, cy, h, T;
V3 origin;
std::vector<float> img;       // H*W*3 (shared by all keyframes)
std::vector<float> vdist_grid, vweight;   // full grid (frozen outside surface)
std::vector<V3> vgrad_grid;

static inline size_t lin3(int i, int j, int k) {
    return (size_t)i + (size_t)DIM * j + (size_t)DIM * DIM * k;
}

// ---- image sampling with ops/image.py == Auxilary.h semantics ----
static inline const float *px(int r, int c) {
    r = std::max(0, std::min(H - 1, r));
    c = std::max(0, std::min(W - 1, c));
    return &img[3 * ((size_t)r * W + c)];
}

static V3 bilinear(float r, float c) {
    int r0 = (int)std::floor(r), c0 = (int)std::floor(c);
    float fr = r - r0, fc = c - c0;
    bool row_ok = r0 + 1 < H, col_ok = c0 + 1 < W;
    const float *v00 = px(r0, c0), *v01 = px(r0, c0 + 1);
    const float *v10 = px(r0 + 1, c0), *v11 = px(r0 + 1, c0 + 1);
    V3 out;
    for (int ch = 0; ch < 3; ++ch) {
        float full = (1 - fc) * (fr * v10[ch] + (1 - fr) * v00[ch])
                     + fc * (fr * v11[ch] + (1 - fr) * v01[ch]);
        float col_only = (1 - fc) * v00[ch] + fc * v01[ch];
        float row_only = fr * v10[ch] + (1 - fr) * v00[ch];
        float val = (row_ok && col_ok) ? full
                    : (col_ok ? col_only : (row_ok ? row_only : v00[ch]));
        (&out.x)[ch] = val;
    }
    return out;
}

// axis 0 = d/d(col) (u), axis 1 = d/d(row) (v) — Auxilary.h:64-123
static V3 img_grad(float r, float c, int axis) {
    int r0 = (int)std::floor(r), c0 = (int)std::floor(c);
    float fr = r - r0, fc = c - c0;
    bool row_ok = r0 + 1 < H, col_ok = c0 + 1 < W;
    V3 out;
    for (int ch = 0; ch < 3; ++ch) {
        float val;
        if (axis == 0) {
            float d_r0 = px(r0, c0 + 1)[ch] - px(r0, c0)[ch];
            float d_r1 = px(r0 + 1, c0 + 1)[ch] - px(r0 + 1, c0)[ch];
            float b_r0 = px(r0, c0)[ch] - px(r0, c0 - 1)[ch];
            float b_r1 = px(r0 + 1, c0)[ch] - px(r0 + 1, c0 - 1)[ch];
            float blended = (1 - fr) * d_r0 + fr * d_r1;
            float blended_back = (1 - fr) * b_r0 + fr * b_r1;
            val = (row_ok && col_ok) ? blended : (!row_ok ? d_r0 : blended_back);
        } else {
            float d_c0 = px(r0 + 1, c0)[ch] - px(r0, c0)[ch];
            float d_c1 = px(r0 + 1, c0 + 1)[ch] - px(r0, c0 + 1)[ch];
            float b_c0 = px(r0, c0)[ch] - px(r0 - 1, c0)[ch];
            float b_c1 = px(r0, c0 + 1)[ch] - px(r0 - 1, c0 + 1)[ch];
            float blended = (1 - fc) * d_c0 + fc * d_c1;
            float blended_back = (1 - fc) * b_c0 + fc * b_c1;
            val = (row_ok && col_ok) ? blended : (!col_ok ? d_c0 : blended_back);
        }
        (&out.x)[ch] = val;
    }
    return out;
}

static inline V3 normal_jac(V3 grad, V3 direction) {
    V3 n_d = mul(direction, -1.f / h);
    float N_inv = 1.f / std::max(norm(grad), 1e-3f);
    float dN = N_inv * N_inv * N_inv * dot(n_d, grad);
    return sub(mul(n_d, N_inv), mul(grad, dN));
}

static void solve_dense(int n, std::vector<double> A, std::vector<double> b,
                        float *out) {
    for (int k = 0; k < n; ++k) {
        int piv = k;
        for (int i = k + 1; i < n; ++i)
            if (std::fabs(A[i * n + k]) > std::fabs(A[piv * n + k])) piv = i;
        if (piv != k) {
            for (int j = 0; j < n; ++j) std::swap(A[k * n + j], A[piv * n + j]);
            std::swap(b[k], b[piv]);
        }
        double d = A[k * n + k];
        for (int i = k + 1; i < n; ++i) {
            double f = A[i * n + k] / d;
            for (int j = k; j < n; ++j) A[i * n + j] -= f * A[k * n + j];
            b[i] -= f * b[k];
        }
    }
    for (int k = n - 1; k >= 0; --k) {
        double s = b[k];
        for (int j = k + 1; j < n; ++j) s -= A[k * n + j] * out[j];
        out[k] = (float)(s / A[k * n + k]);
    }
}

static void wbin(const std::string &path, const void *data, size_t bytes) {
    FILE *f = fopen(path.c_str(), "wb");
    if (!f) { perror(path.c_str()); exit(1); }
    fwrite(data, 1, bytes, f);
    fclose(f);
}

// ------------------------------------------------------------- problem state

size_t N;
std::vector<int> surf;                 // compact -> linear grid index
std::vector<float> sdist;              // [N] distance (the optimized variable)
std::vector<V3> sgrad;                 // [N] stored gradient (updateGrad target)
std::vector<float> salb;               // [N*3] albedo
std::vector<float> sdir;               // [N*3] FD direction per axis
std::vector<int> snbr;                 // [N*3] compact neighbor index, -1 frozen
std::vector<float> snbr_frozen;        // [N*3] frozen neighbor distance
std::vector<Mat3> Rs;                  // [F]
std::vector<V3> ts;                    // [F]
std::vector<float> lights;             // [F*4] SH1
std::vector<V3> cvs;                   // [N] voxel centers

static inline float nbr_dist(size_t s, int ax) {
    int c = snbr[s * 3 + ax];
    return c >= 0 ? sdist[c] : snbr_frozen[s * 3 + ax];
}

static inline V3 fd_grad(size_t s) {
    float d0 = sdist[s];
    float g[3];
    for (int ax = 0; ax < 3; ++ax)
        g[ax] = sdir[s * 3 + ax] * (nbr_dist(s, ax) - d0) / h;
    return v3(g[0], g[1], g[2]);
}

// ----------------------------------------------------------- residual pass

struct Pass {
    std::vector<float> r, w;          // [N*F*3]
    std::vector<uint8_t> mask;        // [N*F]
    std::vector<V3> pcam;             // [N*F]
    std::vector<V3> gu, gv;           // [N*F] image gradients per channel
    double E;                         // photometric energy (sum loss / N)
};

static const float LAM = 0.2f;

static void compute_pass(Pass &P) {
    P.r.assign(N * F * 3, 0.f);
    P.w.assign(N * F * 3, 0.f);
    P.mask.assign(N * F, 0);
    P.pcam.assign(N * F, v3(0, 0, 0));
    P.gu.assign(N * F, v3(0, 0, 0));
    P.gv.assign(N * F, v3(0, 0, 0));
    double Eacc = 0.0;
    float lam2 = LAM * LAM;
    for (size_t s = 0; s < N; ++s) {
        V3 ghat = normalized(sgrad[s]);
        V3 xw = sub(cvs[s], mul(ghat, sdist[s]));
        V3 n_fd = normalized(fd_grad(s));
        const float *rho = &salb[s * 3];
        for (int f = 0; f < F; ++f) {
            V3 pc = mtv(Rs[f], sub(xw, ts[f]));
            float zc = pc.z;
            float safe_z = std::fabs(zc) > 1e-12f ? zc : 1e-12f;
            float u = fx * pc.x / safe_z + cx;
            float v = fy * pc.y / safe_z + cy;
            if (!(u >= 0 && u < W && v >= 0 && v < H)) continue;
            size_t q = s * F + f;
            P.mask[q] = 1;
            P.pcam[q] = pc;
            V3 I = bilinear(v, u);
            P.gu[q] = img_grad(v, u, 0);
            P.gv[q] = img_grad(v, u, 1);
            const float *lf = &lights[f * 4];
            float irr = lf[0] + lf[1] * n_fd.x + lf[2] * n_fd.y + lf[3] * n_fd.z;
            for (int ch = 0; ch < 3; ++ch) {
                float rr = (&I.x)[ch] - rho[ch] * irr;
                P.r[q * 3 + ch] = rr;
                P.w[q * 3 + ch] = 1.f / (1.f + rr * rr / lam2);
                Eacc += std::log1p((double)(rr * rr) / lam2);
            }
        }
    }
    P.E = Eacc / (double)N;
}

static double normal_energy() {
    double acc = 0.0;
    for (size_t s = 0; s < N; ++s) {
        double e = norm(fd_grad(s)) - 1.0;
        acc += e * e;
    }
    return acc / (double)N;
}

// ------------------------------------------------------------------- blocks

static void albedo_block(const Pass &P, float damping) {
    // J = -(l^T SH(ghat_stored)); diagonal normal equations; clamped update
    std::vector<double> b(N * 3, 0.0), diag(N * 3, 0.0);
    for (size_t s = 0; s < N; ++s) {
        V3 ghat = normalized(sgrad[s]);
        for (int f = 0; f < F; ++f) {
            size_t q = s * F + f;
            if (!P.mask[q]) continue;
            const float *lf = &lights[f * 4];
            float Ja = -(lf[0] + lf[1] * ghat.x + lf[2] * ghat.y + lf[3] * ghat.z);
            for (int ch = 0; ch < 3; ++ch) {
                b[s * 3 + ch] += (double)Ja * P.w[q * 3 + ch] * P.r[q * 3 + ch];
                diag[s * 3 + ch] += (double)Ja * Ja * P.w[q * 3 + ch];
            }
        }
    }
    for (size_t qq = 0; qq < N * 3; ++qq) {
        float delta = diag[qq] > 0.0
                          ? (float)(b[qq] / ((1.0 + damping) * diag[qq]))
                          : 0.f;
        float cand = salb[qq] - delta;
        if (cand > 0.f && cand < 1.f) salb[qq] = cand;
    }
}

static void light_block(const Pass &P) {
    // J = -rho_c SH(ghat_stored); per-frame 4x4 solve, no damping
    std::vector<std::vector<double>> Hl(F, std::vector<double>(16, 0.0));
    std::vector<std::vector<double>> gl(F, std::vector<double>(4, 0.0));
    for (size_t s = 0; s < N; ++s) {
        V3 ghat = normalized(sgrad[s]);
        float sh[4] = {1.f, ghat.x, ghat.y, ghat.z};
        const float *rho = &salb[s * 3];
        for (int f = 0; f < F; ++f) {
            size_t q = s * F + f;
            if (!P.mask[q]) continue;
            for (int ch = 0; ch < 3; ++ch) {
                float wch = P.w[q * 3 + ch], rch = P.r[q * 3 + ch];
                float Jl[4] = {-rho[ch] * sh[0], -rho[ch] * sh[1],
                               -rho[ch] * sh[2], -rho[ch] * sh[3]};
                for (int a = 0; a < 4; ++a) {
                    gl[f][a] += (double)wch * Jl[a] * rch;
                    for (int bb2 = 0; bb2 < 4; ++bb2)
                        Hl[f][a * 4 + bb2] += (double)wch * Jl[a] * Jl[bb2];
                }
            }
        }
    }
    for (int f = 0; f < F; ++f) {
        std::vector<double> A = Hl[f];
        for (int a = 0; a < 4; ++a) A[a * 4 + a] += 1e-8;
        float delta[4];
        solve_dense(4, A, gl[f], delta);
        for (int a = 0; a < 4; ++a) lights[f * 4 + a] -= delta[a];
    }
}

static void pose_block(const Pass &P, float damping) {
    for (int f = 0; f < F; ++f) {
        std::vector<double> Hp(36, 0.0), gp(6, 0.0);
        for (size_t s = 0; s < N; ++s) {
            size_t q = s * F + f;
            if (!P.mask[q]) continue;
            V3 pc = P.pcam[q];
            float zi = 1.f / (std::fabs(pc.z) > 1e-12f ? pc.z : 1e-12f);
            float zi2 = zi * zi;
            V3 pi0 = v3(fx * zi, 0, -fx * pc.x * zi2);
            V3 pi1 = v3(0, fy * zi, -fy * pc.y * zi2);
            for (int ch = 0; ch < 3; ++ch) {
                V3 Grow = add(mul(pi0, (&P.gu[q].x)[ch]), mul(pi1, (&P.gv[q].x)[ch]));
                V3 GR = mv(Rs[f], Grow);
                V3 leftc = mul(GR, -1.f);
                V3 rightc = v3(Grow.y * pc.z - Grow.z * pc.y,
                               Grow.z * pc.x - Grow.x * pc.z,
                               Grow.x * pc.y - Grow.y * pc.x);
                float Jp[6] = {leftc.x, leftc.y, leftc.z,
                               rightc.x, rightc.y, rightc.z};
                float wch = P.w[q * 3 + ch], rch = P.r[q * 3 + ch];
                for (int a = 0; a < 6; ++a) {
                    gp[a] += (double)wch * Jp[a] * rch;
                    for (int bb2 = 0; bb2 < 6; ++bb2)
                        Hp[a * 6 + bb2] += (double)wch * Jp[a] * Jp[bb2];
                }
            }
        }
        std::vector<double> A = Hp;
        for (int a = 0; a < 6; ++a)
            A[a * 6 + a] += damping * Hp[a * 6 + a] + 1e-8;
        float xi[6];
        solve_dense(6, A, gp, xi);
        // t -= xi_t;  R <- R exp(-xi_w)   (OptimizerAux.cpp:190-205)
        ts[f] = sub(ts[f], v3(xi[0], xi[1], xi[2]));
        V3 wv = v3(-xi[3], -xi[4], -xi[5]);
        float th = norm(wv);
        Mat3 Rw;
        if (th < 1e-12f) {
            Rw = Mat3{{1, 0, 0, 0, 1, 0, 0, 0, 1}};
        } else {
            V3 a = mul(wv, 1.f / th);
            float c = std::cos(th), s = std::sin(th), C = 1 - c;
            Rw = Mat3{{c + a.x * a.x * C, a.x * a.y * C - a.z * s, a.x * a.z * C + a.y * s,
                       a.y * a.x * C + a.z * s, c + a.y * a.y * C, a.y * a.z * C - a.x * s,
                       a.z * a.x * C - a.y * s, a.z * a.y * C + a.x * s, c + a.z * a.z * C}};
        }
        Mat3 Rn;   // Rs[f] * Rw
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                double acc = 0;
                for (int k = 0; k < 3; ++k)
                    acc += Rs[f].m[i * 3 + k] * Rw.m[k * 3 + j];
                Rn.m[i * 3 + j] = (float)acc;
            }
        Rs[f] = Rn;
    }
}

struct Row { int cols[4]; V3 Jc[4]; V3 r, w; };

static int dist_block(const Pass &P, float w_n, float damping) {
    // photometric rows
    std::vector<Row> rows;
    rows.reserve(N * F / 2);
    for (size_t s = 0; s < N; ++s) {
        float d0 = sdist[s];
        V3 ghat = normalized(sgrad[s]);
        V3 grad_f = fd_grad(s);
        V3 dir = v3(sdir[s * 3], sdir[s * 3 + 1], sdir[s * 3 + 2]);
        V3 dn0 = normal_jac(grad_f, dir);
        V3 dni[3] = {normal_jac(grad_f, v3(-dir.x, 0, 0)),
                     normal_jac(grad_f, v3(0, -dir.y, 0)),
                     normal_jac(grad_f, v3(0, 0, -dir.z))};
        V3 dx0 = sub(mul(ghat, -1.f), mul(dn0, d0));
        const float *rho = &salb[s * 3];
        for (int f = 0; f < F; ++f) {
            size_t q = s * F + f;
            if (!P.mask[q]) continue;
            V3 pc = P.pcam[q];
            float zi = 1.f / (std::fabs(pc.z) > 1e-12f ? pc.z : 1e-12f);
            float zi2 = zi * zi;
            V3 pi0 = v3(fx * zi, 0, -fx * pc.x * zi2);
            V3 pi1 = v3(0, fy * zi, -fy * pc.y * zi2);
            V3 Grow[3];
            for (int ch = 0; ch < 3; ++ch)
                Grow[ch] = add(mul(pi0, (&P.gu[q].x)[ch]),
                               mul(pi1, (&P.gv[q].x)[ch]));
            const float *lf = &lights[f * 4];
            auto chain = [&](V3 dx) {
                V3 rdx = mtv(Rs[f], dx);
                return v3(dot(Grow[0], rdx), dot(Grow[1], rdx), dot(Grow[2], rdx));
            };
            auto shade_term = [&](V3 dn) {
                float dl = lf[1] * dn.x + lf[2] * dn.y + lf[3] * dn.z;
                return v3(rho[0] * dl, rho[1] * dl, rho[2] * dl);
            };
            Row row;
            row.r = v3(P.r[q * 3], P.r[q * 3 + 1], P.r[q * 3 + 2]);
            row.w = v3(P.w[q * 3], P.w[q * 3 + 1], P.w[q * 3 + 2]);
            row.Jc[0] = sub(chain(dx0), shade_term(dn0));
            row.cols[0] = (int)s;
            for (int ax = 0; ax < 3; ++ax) {
                V3 dx = mul(dni[ax], -d0);
                row.Jc[1 + ax] = sub(chain(dx), shade_term(dni[ax]));
                row.cols[1 + ax] = snbr[s * 3 + ax];
            }
            rows.push_back(row);
        }
    }

    // Eikonal regularizer rows (solvers.eikonal_operator): r=|g|-1,
    // J0 = g.(-dir/h)*scale, Ji = g_ax*dir_ax/h*scale, scale=1/max(|g|,eps)
    std::vector<float> eik_r(N), eik_J0(N);
    std::vector<V3> eik_Ji(N);
    if (w_n != 0.f) {
        for (size_t s = 0; s < N; ++s) {
            V3 g = fd_grad(s);
            float gn = norm(g);
            eik_r[s] = gn - 1.f;
            float scale = gn > 0.f ? 1.f / std::max(gn, 1e-12f) : 1.f;
            V3 dir = v3(sdir[s * 3], sdir[s * 3 + 1], sdir[s * 3 + 2]);
            eik_J0[s] = (g.x * (-dir.x) + g.y * (-dir.y) + g.z * (-dir.z))
                        / h * scale;
            eik_Ji[s] = v3(g.x * dir.x / h * scale, g.y * dir.y / h * scale,
                           g.z * dir.z / h * scale);
        }
    }

    // b = J^T W r (+ reg), diag = diag(J^T W J) (+ reg)
    std::vector<double> b(N, 0.0), diag(N, 0.0);
    for (auto &row : rows)
        for (int a = 0; a < 4; ++a) {
            if (row.cols[a] < 0) continue;
            const V3 &J = row.Jc[a];
            diag[row.cols[a]] += (double)row.w.x * J.x * J.x
                                 + (double)row.w.y * J.y * J.y
                                 + (double)row.w.z * J.z * J.z;
            b[row.cols[a]] += (double)row.w.x * J.x * row.r.x
                              + (double)row.w.y * J.y * row.r.y
                              + (double)row.w.z * J.z * row.r.z;
        }
    if (w_n != 0.f)
        for (size_t s = 0; s < N; ++s) {
            b[s] += (double)w_n * eik_J0[s] * eik_r[s];
            diag[s] += (double)w_n * eik_J0[s] * eik_J0[s];
            for (int ax = 0; ax < 3; ++ax) {
                int c = snbr[s * 3 + ax];
                if (c < 0) continue;
                float Ji = (&eik_Ji[s].x)[ax];
                b[c] += (double)w_n * Ji * eik_r[s];
                diag[c] += (double)w_n * Ji * Ji;
            }
        }

    auto matvec = [&](const std::vector<double> &in, std::vector<double> &out) {
        std::fill(out.begin(), out.end(), 0.0);
        for (auto &row : rows) {
            double ax_ = 0, ay = 0, az = 0;
            for (int a = 0; a < 4; ++a) {
                if (row.cols[a] < 0) continue;
                double xa = in[row.cols[a]];
                ax_ += row.Jc[a].x * xa;
                ay += row.Jc[a].y * xa;
                az += row.Jc[a].z * xa;
            }
            ax_ *= row.w.x; ay *= row.w.y; az *= row.w.z;
            for (int a = 0; a < 4; ++a) {
                if (row.cols[a] < 0) continue;
                out[row.cols[a]] += row.Jc[a].x * ax_ + row.Jc[a].y * ay
                                    + row.Jc[a].z * az;
            }
        }
        if (w_n != 0.f)
            for (size_t s = 0; s < N; ++s) {
                double jx = eik_J0[s] * in[s];
                for (int ax = 0; ax < 3; ++ax) {
                    int c = snbr[s * 3 + ax];
                    if (c < 0) continue;
                    jx += (&eik_Ji[s].x)[ax] * in[c];
                }
                jx *= w_n;
                out[s] += eik_J0[s] * jx;
                for (int ax = 0; ax < 3; ++ax) {
                    int c = snbr[s * 3 + ax];
                    if (c < 0) continue;
                    out[c] += (&eik_Ji[s].x)[ax] * jx;
                }
            }
        for (size_t qq = 0; qq < N; ++qq) out[qq] += damping * diag[qq] * in[qq];
    };

    // Jacobi-PCG, the JAX solve's budget (cg_iters=100, tol=1e-6 rel)
    std::vector<double> dsafe(N);
    for (size_t qq = 0; qq < N; ++qq)
        dsafe[qq] = diag[qq] > 0.0 ? (1.0 + damping) * diag[qq] : 1.0;
    std::vector<double> x(N, 0.0), r(b), z(N), p(N), Ap(N);
    double bb = 0;
    for (size_t qq = 0; qq < N; ++qq) bb += b[qq] * b[qq];
    double tol2 = 1e-12 * bb;
    for (size_t qq = 0; qq < N; ++qq) z[qq] = r[qq] / dsafe[qq];
    p = z;
    double rz = 0;
    for (size_t qq = 0; qq < N; ++qq) rz += r[qq] * z[qq];
    int it = 0;
    for (; it < 100; ++it) {
        double rr2 = 0;
        for (size_t qq = 0; qq < N; ++qq) rr2 += r[qq] * r[qq];
        if (rr2 <= tol2) break;
        matvec(p, Ap);
        double pAp = 0;
        for (size_t qq = 0; qq < N; ++qq) pAp += p[qq] * Ap[qq];
        if (pAp <= 0) break;
        double alpha = rz / pAp;
        for (size_t qq = 0; qq < N; ++qq) { x[qq] += alpha * p[qq]; r[qq] -= alpha * Ap[qq]; }
        double rz2 = 0;
        for (size_t qq = 0; qq < N; ++qq) { z[qq] = r[qq] / dsafe[qq]; rz2 += r[qq] * z[qq]; }
        double beta = rz2 / rz;
        rz = rz2;
        for (size_t qq = 0; qq < N; ++qq) p[qq] = z[qq] + beta * p[qq];
    }

    // update: reject |delta| >= sqrt(3) h, then updateGrad (grad := FD grad)
    float lim = std::sqrt(3.f) * h;
    for (size_t s = 0; s < N; ++s) {
        float delta = (float)x[s];
        if (std::fabs(delta) < lim) sdist[s] -= delta;
    }
    for (size_t s = 0; s < N; ++s) sgrad[s] = fd_grad(s);
    return it;
}

// --------------------------------------------------------------------- main

int main(int argc, char **argv) {
    W = argc > 1 ? atoi(argv[1]) : 640;
    H = argc > 2 ? atoi(argv[2]) : 480;
    DIM = argc > 3 ? atoi(argv[3]) : 128;
    F = argc > 4 ? atoi(argv[4]) : 20;
    MAX_IT = argc > 5 ? atoi(argv[5]) : 100;
    std::string out = argc > 6 ? argv[6] : "/tmp/refine_full";
    out += "/";

    fx = 0.9f * W; fy = 0.9f * W; cx = W / 2.f; cy = H / 2.f;
    h = 1.8f / DIM;
    T = 5.f * h;
    const V3 shift = v3(0.f, 0.f, 1.2f);
    origin = sub(shift, mul(v3(1, 1, 1), 0.5f * h * DIM));
    const float damping = 1.0f;
    const float conv_threshold = 5e-3f;
    const float reg_n_raw = 10.0f;     // the sokrates recipe's reg weight

    // ---- synthetic wavy scene (identical formula to bench.py), with
    // sensor noise on the FUSED depth (4 mm, deterministic LCG Box-Muller
    // — the LED production rehearsal's noise level) so the distance block
    // has real geometry error to burn; the image renders from the clean
    // surface ----
    uint64_t rng = 0x9E3779B97F4A7C15ull;
    auto unif = [&]() {
        rng = rng * 6364136223846793005ull + 1442695040888963407ull;
        return (float)((rng >> 11) * (1.0 / 9007199254740992.0));
    };
    auto gauss = [&]() {
        float u1 = std::max(unif(), 1e-12f), u2 = unif();
        return std::sqrt(-2.f * std::log(u1))
               * std::cos(2.f * 3.14159265358979f * u2);
    };
    std::vector<float> depth(W * H);
    std::vector<V3> nrm(W * H);
    img.resize((size_t)W * H * 3);
    for (int v = 0; v < H; ++v)
        for (int u = 0; u < W; ++u) {
            float x0 = (u - cx) / fx, y0 = (v - cy) / fy;
            float z = 1.2f + 0.08f * std::sin(6 * x0) * std::cos(5 * y0)
                      + 0.05f * std::sin(3 * (x0 + y0));
            depth[v * W + u] = z + 0.004f * gauss();
            float dgx = 0.08f * 6 * std::cos(6 * x0) * std::cos(5 * y0)
                        + 0.15f * std::cos(3 * (x0 + y0));
            float dgy = -0.08f * 5 * std::sin(6 * x0) * std::sin(5 * y0)
                        + 0.15f * std::cos(3 * (x0 + y0));
            V3 n = normalized(v3(-dgx, -dgy, 1.f));
            nrm[v * W + u] = n;
            float shade = 0.3f + 0.5f * std::fabs(n.z);
            img[3 * ((size_t)v * W + u)] = shade;
            img[3 * ((size_t)v * W + u) + 1] = shade * 0.9f;
            img[3 * ((size_t)v * W + u) + 2] = shade * 0.8f;
        }

    // ---- fuse one identity frame (VolumetricGradSdf.cpp:78-134, no
    // angle gate — the dump carries the volume so the JAX side loads it) ----
    size_t NV = (size_t)DIM * DIM * DIM;
    vdist_grid.assign(NV, T);
    vweight.assign(NV, 0.f);
    vgrad_grid.assign(NV, v3(0, 0, 0));
    for (int k = 0; k < DIM; ++k)
        for (int j = 0; j < DIM; ++j)
            for (int i = 0; i < DIM; ++i) {
                V3 pw = add(origin, mul(v3((float)i, (float)j, (float)k), h));
                if (pw.z <= 0) continue;
                int u = (int)(cx + fx * pw.x / pw.z + 0.5f);
                int v = (int)(cy + fy * pw.y / pw.z + 0.5f);
                if (u < 0 || u >= W || v < 0 || v >= H) continue;
                float z = depth[v * W + u];
                float sdf = z - pw.z;
                float w = sdf >= 0.f ? 1.f : (sdf >= -T ? 1.f + sdf / T : 0.f);
                if (w == 0.f) continue;
                size_t l = lin3(i, j, k);
                vweight[l] += w;
                float tr = std::max(-T, std::min(T, sdf));
                vdist_grid[l] += (tr - vdist_grid[l]) * w / vweight[l];
                vgrad_grid[l] = sub(vgrad_grid[l], mul(nrm[v * W + u], w));
            }

    // ---- surface set + compact state ----
    std::vector<int> cmap(NV, -1);
    for (size_t l = 0; l < NV; ++l)
        if (vweight[l] > 0.f && std::fabs(vdist_grid[l]) <= std::sqrt(3.f) * h)
            { cmap[l] = (int)surf.size(); surf.push_back((int)l); }
    N = surf.size();
    sdist.resize(N); sgrad.resize(N); salb.assign(N * 3, 0.f);
    cvs.resize(N);
    sdir.resize(N * 3); snbr.resize(N * 3); snbr_frozen.resize(N * 3);
    for (size_t s = 0; s < N; ++s) {
        int l = surf[s];
        int i = l % DIM, j = (l / DIM) % DIM, k = l / (DIM * DIM);
        sdist[s] = vdist_grid[l];
        sgrad[s] = vgrad_grid[l];
        cvs[s] = add(origin, mul(v3((float)i, (float)j, (float)k), h));
        int c[3] = {i, j, k};
        for (int ax = 0; ax < 3; ++ax) {
            int f3[3] = {c[0], c[1], c[2]};
            f3[ax] += 1;
            bool fwd = f3[ax] < DIM && cmap[lin3(f3[0], f3[1], f3[2])] >= 0;
            float dr = fwd ? 1.f : -1.f;
            int n3[3] = {c[0], c[1], c[2]};
            n3[ax] += (int)dr;
            n3[ax] = std::max(0, std::min(DIM - 1, n3[ax]));
            size_t ln = lin3(n3[0], n3[1], n3[2]);
            sdir[s * 3 + ax] = dr;
            snbr[s * 3 + ax] = cmap[ln];
            snbr_frozen[s * 3 + ax] = vdist_grid[ln];
        }
    }

    // ---- keyframe poses: Rz(0.004 f) + small translation, plus pose
    // NOISE (3 mm / 0.003 rad — an imperfect tracker, the LED rehearsal's
    // level) so the pose block has real work ----
    Rs.resize(F); ts.resize(F);
    std::vector<float> poses_out(F * 16, 0.f);
    for (int f = 0; f < F; ++f) {
        float a = 0.004f * f;
        float ca = std::cos(a), sa = std::sin(a);
        Mat3 Rz{{ca, -sa, 0, sa, ca, 0, 0, 0, 1}};
        // small-angle rotation error Rw ~ exp(skew(w)), |w| ~ 0.003
        V3 wv = v3(0.003f * gauss(), 0.003f * gauss(), 0.003f * gauss());
        float th = norm(wv);
        Mat3 Rw{{1, 0, 0, 0, 1, 0, 0, 0, 1}};
        if (th > 1e-12f) {
            V3 ax = mul(wv, 1.f / th);
            float c = std::cos(th), s = std::sin(th), C = 1 - c;
            Rw = Mat3{{c + ax.x * ax.x * C, ax.x * ax.y * C - ax.z * s, ax.x * ax.z * C + ax.y * s,
                       ax.y * ax.x * C + ax.z * s, c + ax.y * ax.y * C, ax.y * ax.z * C - ax.x * s,
                       ax.z * ax.x * C - ax.y * s, ax.z * ax.y * C + ax.x * s, c + ax.z * ax.z * C}};
        }
        Mat3 Rn;
        for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
                double acc = 0;
                for (int k = 0; k < 3; ++k) acc += Rz.m[i * 3 + k] * Rw.m[k * 3 + j];
                Rn.m[i * 3 + j] = (float)acc;
            }
        Rs[f] = Rn;
        ts[f] = v3(0.003f * f + 0.003f * gauss(),
                   -0.002f * f + 0.003f * gauss(),
                   0.001f * f + 0.003f * gauss());
        float *Pp = &poses_out[f * 16];
        for (int i = 0; i < 3; ++i) {
            for (int j = 0; j < 3; ++j) Pp[i * 4 + j] = Rs[f].m[i * 3 + j];
            Pp[i * 4 + 3] = (&ts[f].x)[i];
        }
        Pp[15] = 1;
    }
    // SH1 light init (PsOptimizer.cpp:25-42): l = [0.02, R (0,0,-1)]
    lights.assign(F * 4, 0.f);
    for (int f = 0; f < F; ++f) {
        V3 d = mv(Rs[f], v3(0, 0, -1));
        lights[f * 4 + 0] = 0.02f;
        lights[f * 4 + 1] = d.x;
        lights[f * 4 + 2] = d.y;
        lights[f * 4 + 3] = d.z;
    }

    // ---- dump the initial problem for the JAX side ----
    {
        std::vector<float> grad_flat(NV * 3);
        for (size_t l = 0; l < NV; ++l) {
            grad_flat[3 * l] = vgrad_grid[l].x;
            grad_flat[3 * l + 1] = vgrad_grid[l].y;
            grad_flat[3 * l + 2] = vgrad_grid[l].z;
        }
        wbin(out + "image.f32", img.data(), img.size() * 4);
        wbin(out + "dist.f32", vdist_grid.data(), NV * 4);
        wbin(out + "grad.f32", grad_flat.data(), NV * 12);
        wbin(out + "weight.f32", vweight.data(), NV * 4);
        wbin(out + "surf.i32", surf.data(), N * 4);
        wbin(out + "poses.f32", poses_out.data(), poses_out.size() * 4);
        wbin(out + "lights.f32", lights.data(), lights.size() * 4);
        FILE *f = fopen((out + "meta.json").c_str(), "w");
        fprintf(f,
                "{\"W\": %d, \"H\": %d, \"DIM\": %d, \"F\": %d, \"N\": %zu, "
                "\"fx\": %.9g, \"fy\": %.9g, \"cx\": %.9g, \"cy\": %.9g, "
                "\"h\": %.9g, \"T\": %.9g, \"shift\": [0.0, 0.0, 1.2], "
                "\"damping\": %.9g, \"lambda\": %.9g, \"reg_n\": %.9g, "
                "\"max_it\": %d, \"conv_threshold\": %.9g}\n",
                W, H, DIM, F, N, fx, fy, cx, cy, h, T, damping, LAM,
                reg_n_raw, MAX_IT, conv_threshold);
        fclose(f);
    }

    // =========================== TIMED LOOP ===========================
    auto t0 = std::chrono::steady_clock::now();
    auto secs = [&]() {
        return std::chrono::duration<double>(
            std::chrono::steady_clock::now() - t0).count();
    };

    // initAlbedo (Optimizer.cpp:50-81): mean observed intensity
    {
        std::vector<double> acc(N * 3, 0.0);
        std::vector<int> cnt(N, 0);
        for (size_t s = 0; s < N; ++s) {
            V3 ghat = normalized(sgrad[s]);
            V3 xw = sub(cvs[s], mul(ghat, sdist[s]));
            for (int f = 0; f < F; ++f) {
                V3 pc = mtv(Rs[f], sub(xw, ts[f]));
                float safe_z = std::fabs(pc.z) > 1e-12f ? pc.z : 1e-12f;
                float u = fx * pc.x / safe_z + cx;
                float v = fy * pc.y / safe_z + cy;
                if (!(u >= 0 && u < W && v >= 0 && v < H)) continue;
                V3 I = bilinear(v, u);
                for (int ch = 0; ch < 3; ++ch) acc[s * 3 + ch] += (&I.x)[ch];
                cnt[s]++;
            }
            for (int ch = 0; ch < 3; ++ch)
                salb[s * 3 + ch] = cnt[s] > 0
                    ? (float)(acc[s * 3 + ch] / cnt[s]) : 0.f;
        }
    }

    Pass P;
    compute_pass(P);
    double E = P.E;
    double E_n = normal_energy();
    float w_n = reg_n_raw * (float)(E / E_n);   // weight normalization
    double E_total = E + w_n * E_n;
    std::vector<double> E_vec{E_total};

    double t_alb = 0, t_light = 0, t_dist = 0, t_pose = 0, t_pass = 0;
    int iter = 0, cg_its_last = 0;
    bool converged = false;
    for (; iter < MAX_IT; ++iter) {
        double ta = secs();
        albedo_block(P, damping);
        double tb = secs(); t_alb += tb - ta;
        compute_pass(P);
        E = P.E;
        E_total = E + w_n * E_n;
        double tc = secs(); t_pass += tc - tb;

        light_block(P);
        double td = secs(); t_light += td - tc;
        compute_pass(P);
        E = P.E;
        E_total = E + w_n * E_n;
        double te = secs(); t_pass += te - td;

        cg_its_last = dist_block(P, w_n, damping);
        double tf = secs(); t_dist += tf - te;
        compute_pass(P);
        E = P.E;
        E_n = normal_energy();
        E_total = E + w_n * E_n;
        double tg = secs(); t_pass += tg - tf;

        pose_block(P, damping);
        double th2 = secs(); t_pose += th2 - tg;
        compute_pass(P);
        E = P.E;
        E_total = E + w_n * E_n;
        double ti = secs(); t_pass += ti - th2;

        E_vec.push_back(E_total);
        double rel = std::fabs(E_vec.end()[-2] - E_total)
                     / std::max(std::fabs(E_vec.end()[-2]), 1e-12);
        fprintf(stderr, "[cpp-full] iter %d E=%.6g E_n=%.6g total=%.6g rel=%.4g cg=%d t=%.1fs\n",
                iter, E, E_n, E_total, rel, cg_its_last, secs());
        if (rel < conv_threshold) { converged = true; ++iter; break; }
        if (E_vec.end()[-2] < E_total) { ++iter; break; }   // diverged
    }
    double total_s = secs();

    printf("{\"N\": %zu, \"iters\": %d, \"converged\": %s, "
           "\"E0\": %.9g, \"E_final\": %.9g, \"w_n\": %.9g, "
           "\"total_s\": %.6g, \"albedo_s\": %.6g, \"light_s\": %.6g, "
           "\"dist_s\": %.6g, \"pose_s\": %.6g, \"pass_s\": %.6g}\n",
           N, iter, converged ? "true" : "false",
           E_vec.front(), E_vec.back(), w_n,
           total_s, t_alb, t_light, t_dist, t_pose, t_pass);
    return 0;
}

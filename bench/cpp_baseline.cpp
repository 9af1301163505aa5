// Single-threaded CPU baseline for the voxelPS hot path, measured because the
// reference repo cannot be built here (its vendored Eigen/Sophus/CLI11/json
// submodules are empty and the image has no network).  This reimplements the
// reference's two hot loops with the same algorithm, data layout (AoS voxel
// struct) and iteration budgets:
//   * rigid GN tracking: per-pixel backproject -> nearest-voxel Gradient-SDF
//     query psi = d + ghat.(c_v - p), J = [ghat; p x ghat], accumulate
//     (E, g, H), 6x6 Cholesky solve, pose update exp(-xi), <=50 iters,
//     early exit ||xi||^2 < 1e-6   (RigidPointOptimizer.cpp:27-76)
//   * volumetric fusion: for every voxel project into the frame, gate, and
//     update running means of dist/color + gradient accumulation
//     (VolumetricGradSdf.cpp:78-134)
// Plain C++17, no external deps, -O3, one thread — the reference's own
// execution model (SURVEY §2.1: its OpenMP variant is not even compiled).
//
// Usage: cpp_baseline W H DIM FRAMES [dump_path]
//   -> prints JSON with per-stage seconds; with dump_path, also writes a
//      binary dump (poses + fused volume) for the cross-implementation
//      numerical parity test (tests/test_cpp_parity.py).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <vector>

struct V3 { float x, y, z; };
static inline V3 v3(float x, float y, float z) { return {x, y, z}; }
static inline V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 mul(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float norm(V3 a) { return std::sqrt(dot(a, a)); }

struct Mat3 { float m[9]; };
static inline V3 mv(const Mat3 &R, V3 p) {
    return {R.m[0] * p.x + R.m[1] * p.y + R.m[2] * p.z,
            R.m[3] * p.x + R.m[4] * p.y + R.m[5] * p.z,
            R.m[6] * p.x + R.m[7] * p.y + R.m[8] * p.z};
}
static inline V3 mtv(const Mat3 &R, V3 p) {  // R^T p
    return {R.m[0] * p.x + R.m[3] * p.y + R.m[6] * p.z,
            R.m[1] * p.x + R.m[4] * p.y + R.m[7] * p.z,
            R.m[2] * p.x + R.m[5] * p.y + R.m[8] * p.z};
}
static Mat3 matmul(const Mat3 &A, const Mat3 &B) {
    Mat3 C{};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            float s = 0;
            for (int k = 0; k < 3; ++k) s += A.m[3 * i + k] * B.m[3 * k + j];
            C.m[3 * i + j] = s;
        }
    return C;
}

// Rodrigues
static Mat3 so3exp(V3 w) {
    float th = norm(w);
    Mat3 R{};
    R.m[0] = R.m[4] = R.m[8] = 1.f;
    float a, b;
    if (th < 1e-5f) { a = 1.f - th * th / 6.f; b = 0.5f - th * th / 24.f; }
    else { a = std::sin(th) / th; b = (1.f - std::cos(th)) / (th * th); }
    float K[9] = {0, -w.z, w.y, w.z, 0, -w.x, -w.y, w.x, 0};
    float K2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            float s = 0;
            for (int k = 0; k < 3; ++k) s += K[3 * i + k] * K[3 * k + j];
            K2[3 * i + j] = s;
        }
    for (int i = 0; i < 9; ++i) R.m[i] += a * K[i] + b * K2[i];
    return R;
}

// SE3 exp with translation-first tangent [rho, w]
struct SE3 { Mat3 R; V3 t; };
static SE3 se3exp(const float xi[6]) {
    V3 rho = v3(xi[0], xi[1], xi[2]);
    V3 w = v3(xi[3], xi[4], xi[5]);
    float th = norm(w);
    Mat3 R = so3exp(w);
    float b, c;
    if (th < 1e-5f) { b = 0.5f - th * th / 24.f; c = 1.f / 6.f - th * th / 120.f; }
    else {
        b = (1.f - std::cos(th)) / (th * th);
        c = (th - std::sin(th)) / (th * th * th);
    }
    float K[9] = {0, -w.z, w.y, w.z, 0, -w.x, -w.y, w.x, 0};
    float K2[9];
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            float s = 0;
            for (int k = 0; k < 3; ++k) s += K[3 * i + k] * K[3 * k + j];
            K2[3 * i + j] = s;
        }
    Mat3 V{};
    V.m[0] = V.m[4] = V.m[8] = 1.f;
    for (int i = 0; i < 9; ++i) V.m[i] += b * K[i] + c * K2[i];
    return {R, mv(V, rho)};
}

// 6x6 Cholesky solve
static void chol_solve6(float H[36], float g[6], float out[6]) {
    float L[36] = {0};
    for (int i = 0; i < 6; ++i) {
        for (int j = 0; j <= i; ++j) {
            float s = H[6 * i + j];
            for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
            if (i == j) L[6 * i + j] = std::sqrt(std::max(s, 1e-12f));
            else L[6 * i + j] = s / L[6 * j + j];
        }
    }
    float y[6];
    for (int i = 0; i < 6; ++i) {
        float s = g[i];
        for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
        y[i] = s / L[6 * i + i];
    }
    for (int i = 5; i >= 0; --i) {
        float s = y[i];
        for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * out[k];
        out[i] = s / L[6 * i + i];
    }
}

struct SdfVoxel { float dist; V3 grad; float weight; float r, g, b; };

int main(int argc, char **argv) {
    int W = argc > 1 ? atoi(argv[1]) : 640;
    int H = argc > 2 ? atoi(argv[2]) : 480;
    int DIM = argc > 3 ? atoi(argv[3]) : 128;
    int FRAMES = argc > 4 ? atoi(argv[4]) : 5;

    const float fx = 0.9f * W, fy = 0.9f * W;
    const float cx = W / 2.f, cy = H / 2.f;
    const float h = 1.8f / DIM;             // grid spans most of the scene
    const float T = 5.f * h;
    const float zmin = 0.5f, zmax = 3.5f;
    const V3 shift = v3(0.f, 0.f, 1.2f);
    const V3 origin = sub(shift, mul(v3(1, 1, 1), 0.5f * h * DIM));

    // synthetic wavy depth + inward normals (same scene as bench.py);
    // nsq is the per-pixel cached 1/||ray||^2 exactly like the reference's
    // NormalEstimator n_sq_inv map (VolumetricGradSdf.cpp:116)
    std::vector<float> depth(W * H), nsqmap(W * H);
    std::vector<V3> nrm(W * H);
    for (int v = 0; v < H; ++v)
        for (int u = 0; u < W; ++u) {
            float x0 = (u - cx) / fx, y0 = (v - cy) / fy;
            float z = 1.2f + 0.08f * std::sin(6 * x0) * std::cos(5 * y0)
                      + 0.05f * std::sin(3 * (x0 + y0));
            depth[v * W + u] = z;
            float dgx = 0.08f * 6 * std::cos(6 * x0) * std::cos(5 * y0)
                        + 0.15f * std::cos(3 * (x0 + y0));
            float dgy = -0.08f * 5 * std::sin(6 * x0) * std::sin(5 * y0)
                        + 0.15f * std::cos(3 * (x0 + y0));
            V3 n = v3(-dgx, -dgy, 1.f);
            nrm[v * W + u] = mul(n, 1.f / norm(n));
            nsqmap[v * W + u] = 1.f / (1.f + x0 * x0 + y0 * y0);
        }

    size_t NV = (size_t)DIM * DIM * DIM;
    std::vector<SdfVoxel> vox(NV, SdfVoxel{T, {0, 0, 0}, 0, 0, 0, 0});

    SE3 pose{{{1, 0, 0, 0, 1, 0, 0, 0, 1}}, {0, 0, 0}};

    auto fuse = [&](const SE3 &P) {
        for (int k = 0; k < DIM; ++k)
            for (int j = 0; j < DIM; ++j)
                for (int i = 0; i < DIM; ++i) {
                    size_t lin = (size_t)i + (size_t)DIM * j + (size_t)DIM * DIM * k;
                    V3 pw = add(origin, mul(v3((float)i, (float)j, (float)k), h));
                    V3 pc = mtv(P.R, sub(pw, P.t));
                    if (pc.z < 0.f) continue;
                    int u = (int)(cx + fx * pc.x / pc.z + 0.5f);
                    int v = (int)(cy + fy * pc.y / pc.z + 0.5f);
                    if (u < 0 || u >= W || v < 0 || v >= H) continue;
                    float z = depth[v * W + u];
                    if (z <= zmin || z >= zmax) continue;
                    float sdf = z - pc.z;
                    float w = sdf >= 0.f ? 1.f : (sdf >= -T ? 1.f + sdf / T : 0.f);
                    if (w == 0.f) continue;
                    V3 n = nrm[v * W + u];
                    V3 ray = mul(pc, 1.f / pc.z);
                    float d = dot(n, ray);
                    float nsq = nsqmap[v * W + u];
                    if (d * d * nsq < 0.25f * 0.25f) continue;
                    SdfVoxel &vx = vox[lin];
                    vx.weight += w;
                    float tr = std::max(-T, std::min(T, sdf));
                    vx.dist += (tr - vx.dist) * w / vx.weight;
                    V3 nw = mv(P.R, n);
                    vx.grad = sub(vx.grad, mul(nw, w));
                    vx.r += (0.5f - vx.r) * w / vx.weight;
                    vx.g += (0.5f - vx.g) * w / vx.weight;
                    vx.b += (0.5f - vx.b) * w / vx.weight;
                }
    };

    auto track = [&](SE3 &P) -> int {
        for (int it = 0; it < 50; ++it) {
            float E = 0, g6[6] = {0}, H66[36] = {0};
            size_t cnt = 0;
            for (int v = 0; v < H; ++v)
                for (int u = 0; u < W; ++u) {
                    float z = depth[v * W + u];
                    if (z <= zmin || z >= zmax) continue;
                    float x0 = (u - cx) / fx, y0 = (v - cy) / fy;
                    V3 pc = v3(x0 * z, y0 * z, z);
                    V3 pw = add(mv(P.R, pc), P.t);
                    // nearest voxel with border rejection
                    float fi = (pw.x - origin.x) / h;
                    float fj = (pw.y - origin.y) / h;
                    float fk = (pw.z - origin.z) / h;
                    if (fi <= 0 || fj <= 0 || fk <= 0 || fi >= DIM - 1 ||
                        fj >= DIM - 1 || fk >= DIM - 1)
                        continue;
                    int ii = (int)(fi + 0.5f), jj = (int)(fj + 0.5f), kk = (int)(fk + 0.5f);
                    size_t lin = (size_t)ii + (size_t)DIM * jj + (size_t)DIM * DIM * kk;
                    const SdfVoxel &vx = vox[lin];
                    if (vx.weight <= 0.f) continue;
                    float gn = norm(vx.grad);
                    if (gn < 1e-12f) continue;
                    V3 gh = mul(vx.grad, 1.f / gn);
                    V3 cv = add(origin, mul(v3((float)ii, (float)jj, (float)kk), h));
                    float psi = vx.dist + dot(gh, sub(cv, pw));
                    V3 pxg = cross(pw, gh);
                    float J[6] = {gh.x, gh.y, gh.z, pxg.x, pxg.y, pxg.z};
                    E += psi * psi;
                    for (int a = 0; a < 6; ++a) {
                        g6[a] += psi * J[a];
                        for (int b2 = 0; b2 < 6; ++b2) H66[6 * a + b2] += J[a] * J[b2];
                    }
                    ++cnt;
                }
            if (cnt == 0) return it;
            float xi[6];
            chol_solve6(H66, g6, xi);
            float n2 = 0;
            for (int a = 0; a < 6; ++a) n2 += xi[a] * xi[a];
            if (n2 < 1e-6f) return it;
            float nxi[6];
            for (int a = 0; a < 6; ++a) nxi[a] = -xi[a];
            SE3 d = se3exp(nxi);
            P = {matmul(d.R, P.R), add(mv(d.R, P.t), d.t)};
        }
        return 50;
    };

    using clk = std::chrono::steady_clock;
    // build the map from frame 0
    fuse(pose);

    double track_s = 0, fuse_s = 0;
    int total_iters = 0;
    std::vector<float> dump_poses;   // per-frame tracked pose, 4x4 row-major
    std::vector<int> dump_iters;
    for (int f = 0; f < FRAMES; ++f) {
        // start each frame from a small pose offset (realistic inter-frame motion)
        float xi0[6] = {0.004f, -0.003f, 0.005f, 0.002f, -0.002f, 0.0015f};
        SE3 off = se3exp(xi0);
        SE3 P = {matmul(off.R, pose.R), add(mv(off.R, pose.t), off.t)};
        auto t0 = clk::now();
        int it = track(P);
        total_iters += it;
        auto t1 = clk::now();
        fuse(P);
        auto t2 = clk::now();
        track_s += std::chrono::duration<double>(t1 - t0).count();
        fuse_s += std::chrono::duration<double>(t2 - t1).count();
        dump_iters.push_back(it);
        const float row[16] = {P.R.m[0], P.R.m[1], P.R.m[2], P.t.x,
                               P.R.m[3], P.R.m[4], P.R.m[5], P.t.y,
                               P.R.m[6], P.R.m[7], P.R.m[8], P.t.z,
                               0.f, 0.f, 0.f, 1.f};
        dump_poses.insert(dump_poses.end(), row, row + 16);
    }

    if (argc > 5) {
        // binary dump for the cross-implementation parity test:
        // int32 [W H DIM FRAMES], FRAMES*(16 f32 pose + 1 i32 iters),
        // then dist[NV], weight[NV], grad[NV*3], r[NV] as f32
        FILE *fp = fopen(argv[5], "wb");
        if (!fp) { fprintf(stderr, "cannot open %s\n", argv[5]); return 1; }
        int hdr[4] = {W, H, DIM, FRAMES};
        fwrite(hdr, sizeof(int), 4, fp);
        for (int f = 0; f < FRAMES; ++f) {
            fwrite(&dump_poses[16 * f], sizeof(float), 16, fp);
            fwrite(&dump_iters[f], sizeof(int), 1, fp);
        }
        std::vector<float> buf(NV);
        for (size_t i = 0; i < NV; ++i) buf[i] = vox[i].dist;
        fwrite(buf.data(), sizeof(float), NV, fp);
        for (size_t i = 0; i < NV; ++i) buf[i] = vox[i].weight;
        fwrite(buf.data(), sizeof(float), NV, fp);
        std::vector<float> gbuf(NV * 3);
        for (size_t i = 0; i < NV; ++i) {
            gbuf[3 * i] = vox[i].grad.x;
            gbuf[3 * i + 1] = vox[i].grad.y;
            gbuf[3 * i + 2] = vox[i].grad.z;
        }
        fwrite(gbuf.data(), sizeof(float), NV * 3, fp);
        for (size_t i = 0; i < NV; ++i) buf[i] = vox[i].r;
        fwrite(buf.data(), sizeof(float), NV, fp);
        fclose(fp);
    }

    double per_frame = (track_s + fuse_s) / FRAMES;
    printf("{\"frames\": %d, \"track_s\": %.6f, \"fuse_s\": %.6f, "
           "\"per_frame_s\": %.6f, \"fps\": %.6f, \"gn_iters\": %d, "
           "\"gn_iters_per_s\": %.3f}\n",
           FRAMES, track_s, fuse_s, per_frame, 1.0 / per_frame, total_iters,
           total_iters / track_s);
    return 0;
}

// Native marching-tetrahedra isosurface extraction.
//
// C++ counterpart of the numpy marching_tets of
// envidr_tpu_torch/apps/mesh_extract.py (a copy of the JAX package's
// native/mtets.cpp) — the mesh-extraction hot loop runs on host CPU (the
// reference likewise uses a C++ extension, PyMCubes, for this;
// nerf/utils.py:269).  Single pass over cells, 6-tet decomposition, linear
// zero-crossing interpolation, vertex welding via a hash map.  Exposed
// through a plain C ABI for ctypes.
//
// Built by envidr_tpu_torch/native/__init__.py: g++ -O3 -shared -fPIC

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

const int CORNERS[8][3] = {{0,0,0},{1,0,0},{1,1,0},{0,1,0},
                           {0,0,1},{1,0,1},{1,1,1},{0,1,1}};
const int TETS[6][4] = {{0,5,1,6},{0,1,2,6},{0,2,3,6},
                        {0,3,7,6},{0,7,4,6},{0,4,5,6}};
const int TET_EDGES[6][2] = {{0,1},{0,2},{0,3},{1,2},{1,3},{2,3}};
// triangles (as edge-index triples) per 4-bit inside pattern; -1 terminated
const int CASES[16][7] = {
    {-1},                      // 0000
    {0,1,2,-1},                // 0001
    {0,4,3,-1},                // 0010
    {1,2,4, 1,4,3,-1},         // 0011
    {1,3,5,-1},                // 0100
    {0,3,5, 0,5,2,-1},         // 0101
    {0,4,5, 0,5,1,-1},         // 0110
    {2,5,4,-1},                // 0111
    {2,5,4,-1},                // 1000  (complement of 0111)
    {0,1,5, 0,5,4,-1},         // 1001
    {0,2,5, 0,5,3,-1},         // 1010
    {1,3,5,-1},                // 1011
    {1,3,4, 1,4,2,-1},         // 1100
    {0,4,3,-1},                // 1101
    {0,1,2,-1},                // 1110
    {-1},                      // 1111
};

struct Weld {
    std::unordered_map<uint64_t, int64_t> map;
    std::vector<double> verts;  // xyz triples
    int64_t add(double x, double y, double z) {
        // quantize at 1/1024 voxel like the python path
        uint64_t kx = (uint64_t)(int64_t)llround(x * 1024.0) & 0x1FFFFF;
        uint64_t ky = (uint64_t)(int64_t)llround(y * 1024.0) & 0x1FFFFF;
        uint64_t kz = (uint64_t)(int64_t)llround(z * 1024.0) & 0x1FFFFF;
        uint64_t key = (kx << 42) | (ky << 21) | kz;
        auto it = map.find(key);
        if (it != map.end()) return it->second;
        int64_t id = (int64_t)(verts.size() / 3);
        map.emplace(key, id);
        verts.push_back(x); verts.push_back(y); verts.push_back(z);
        return id;
    }
};

}  // namespace

extern "C" {

// Returns number of triangles; fills caller-owned growable buffers via the
// two-call pattern: first call with out_* null to get counts is avoided —
// instead we allocate internally and hand out pointers + a free function.
struct MtResult {
    double* verts;
    int64_t* faces;
    int64_t n_verts;
    int64_t n_faces;
};

MtResult* marching_tets(const float* field, int64_t R, float iso) {
    Weld weld;
    std::vector<int64_t> faces;
    const int64_t R2 = R * R;
    auto F = [&](int64_t x, int64_t y, int64_t z) -> double {
        return (double)field[x * R2 + y * R + z] - iso;
    };
    double epos[6][3];
    for (int64_t x = 0; x + 1 < R; ++x)
    for (int64_t y = 0; y + 1 < R; ++y)
    for (int64_t z = 0; z + 1 < R; ++z) {
        double cv[8];
        double cp[8][3];
        bool any_neg = false, any_pos = false;
        for (int c = 0; c < 8; ++c) {
            cv[c] = F(x + CORNERS[c][0], y + CORNERS[c][1], z + CORNERS[c][2]);
            cp[c][0] = (double)(x + CORNERS[c][0]);
            cp[c][1] = (double)(y + CORNERS[c][1]);
            cp[c][2] = (double)(z + CORNERS[c][2]);
            (cv[c] < 0 ? any_neg : any_pos) = true;
        }
        if (!any_neg || !any_pos) continue;
        for (int t = 0; t < 6; ++t) {
            double v[4];
            const double* p[4];
            int code = 0;
            for (int k = 0; k < 4; ++k) {
                v[k] = cv[TETS[t][k]];
                p[k] = cp[TETS[t][k]];
                if (v[k] < 0) code |= 1 << k;
            }
            if (code == 0 || code == 15) continue;
            for (int e = 0; e < 6; ++e) {
                double a = v[TET_EDGES[e][0]], b = v[TET_EDGES[e][1]];
                double denom = a - b;
                double tt = a / (std::fabs(denom) < 1e-12 ? 1e-12 : denom);
                tt = tt < 0 ? 0 : (tt > 1 ? 1 : tt);
                const double* pa = p[TET_EDGES[e][0]];
                const double* pb = p[TET_EDGES[e][1]];
                for (int d = 0; d < 3; ++d)
                    epos[e][d] = pa[d] + tt * (pb[d] - pa[d]);
            }
            const int* tri = CASES[code];
            for (int i = 0; tri[i] >= 0; i += 3) {
                int64_t a = weld.add(epos[tri[i]][0], epos[tri[i]][1], epos[tri[i]][2]);
                int64_t b = weld.add(epos[tri[i+1]][0], epos[tri[i+1]][1], epos[tri[i+1]][2]);
                int64_t c = weld.add(epos[tri[i+2]][0], epos[tri[i+2]][1], epos[tri[i+2]][2]);
                if (a == b || b == c || a == c) continue;
                faces.push_back(a); faces.push_back(b); faces.push_back(c);
            }
        }
    }
    MtResult* r = new MtResult;
    r->n_verts = (int64_t)(weld.verts.size() / 3);
    r->n_faces = (int64_t)(faces.size() / 3);
    r->verts = new double[weld.verts.size()];
    std::memcpy(r->verts, weld.verts.data(), weld.verts.size() * sizeof(double));
    r->faces = new int64_t[faces.size()];
    std::memcpy(r->faces, faces.data(), faces.size() * sizeof(int64_t));
    return r;
}

void free_result(MtResult* r) {
    delete[] r->verts;
    delete[] r->faces;
    delete r;
}

}  // extern "C"

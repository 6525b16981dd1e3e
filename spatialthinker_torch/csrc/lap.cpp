// Linear assignment (minimization) via the classical Hungarian algorithm with
// potentials (Jonker-Volgenant style shortest augmenting paths), O(n^3).
//
// The port's copy of spatialthinker_tpu/csrc/lap.cpp, the same solver line
// for line: where costs tie, it picks the same optimal assignment as the JAX
// package's matcher. Host code (no CUDA): the spatial reward's Hungarian
// matching (rewards/matching.py) calls it once per GT/pred pair per sample
// per rollout, in place of scipy.optimize.linear_sum_assignment. Built with
// g++ and loaded through ctypes by csrc/lap.py.

#include <cfloat>
#include <cstring>
#include <vector>

extern "C" {

// cost: row-major nr x nc. Output: col_of_row[nr] (-1 if unassigned).
// Returns 0 on success.
int lap_solve(const double* cost, int nr, int nc, int* col_of_row) {
    int n = nr > nc ? nr : nc;  // pad to square; dummy cells cost 0
    auto C = [&](int i, int j) -> double {
        return (i < nr && j < nc) ? cost[(size_t)i * nc + j] : 0.0;
    };

    // 1-based arrays; p[j] = row assigned to column j (0 = none yet)
    std::vector<double> u(n + 1, 0.0), v(n + 1, 0.0), minv(n + 1, 0.0);
    std::vector<int> p(n + 1, 0), way(n + 1, 0);
    std::vector<char> used(n + 1, 0);

    for (int i = 1; i <= n; ++i) {
        p[0] = i;
        int j0 = 0;
        std::fill(minv.begin(), minv.end(), DBL_MAX);
        std::fill(used.begin(), used.end(), 0);
        do {
            used[j0] = 1;
            int i0 = p[j0], j1 = 0;
            double delta = DBL_MAX;
            for (int j = 1; j <= n; ++j) {
                if (used[j]) continue;
                double cur = C(i0 - 1, j - 1) - u[i0] - v[j];
                if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
                if (minv[j] < delta) { delta = minv[j]; j1 = j; }
            }
            for (int j = 0; j <= n; ++j) {
                if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
                else { minv[j] -= delta; }
            }
            j0 = j1;
        } while (p[j0] != 0);
        // augment
        do {
            int j1 = way[j0];
            p[j0] = p[j1];
            j0 = j1;
        } while (j0);
    }

    for (int i = 0; i < nr; ++i) col_of_row[i] = -1;
    for (int j = 1; j <= n; ++j) {
        int i = p[j] - 1;
        if (i >= 0 && i < nr && j - 1 < nc) col_of_row[i] = j - 1;
    }
    return 0;
}

}  // extern "C"

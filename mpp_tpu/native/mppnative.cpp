// mppnative: C++ runtime layer for mpp_tpu.
//
// Re-implementation of the *setup/runtime* subsystems the
// reference consumes from PETSc (SURVEY.md section 2.0):
//
//  * mpp_csr_template      -- static CSR sparsity discovery from
//                             connection-set COO contributions; replaces
//                             PETSc Mat AIJ + MATPREALLOCATOR two-pass
//                             discovery (soe/SystemOfEquationsBaseType.
//                             F90:593-613).  Runs at problem-setup time on
//                             the host; the resulting slot map makes
//                             device-side assembly a single scatter-add.
//  * mpp_structured_connections -- internal connection generation for
//                             structured meshes (util/mpp_mesh_utils.F90:
//                             ComputeInternalConnections).
//  * mpp_petsc_vec_{read,write} -- PETSc binary Vec codec (PetscViewer
//                             binary format: big-endian i32 classid
//                             1211214, i32 n, f64 data) used for
//                             checkpoints, BC data and the RSL psihat
//                             table (util/RSLPsiHat.F90:26-41).
//
// Exposed as a plain C ABI consumed via ctypes (mpp_tpu/native/__init__.py).
// The hot compute path stays in XLA/Pallas; this layer is the host-side
// graph-builder / IO runtime, where the reference used PETSc's C code.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CSR sparsity discovery (MATPREALLOCATOR analog)
//
// Inputs: ncoo contribution coordinates (rows[i], cols[i]) collected from
// connection sets / block offsets.  Outputs match numpy's
// unique(return_inverse) contract used by ops/sparse.csr_template:
// unique (row, col) pairs sorted lexicographically; slots[i] = index of
// contribution i's (row, col) in the sorted unique set.
//
// Two-pass protocol so the caller can size buffers:
//   pass 1: indices_out == nullptr -> only nnz_out is written.
//   pass 2: caller allocates indptr [n_rows+1] i32, indices_out [nnz] i32,
//           slots_out [ncoo] i32.
// Returns 0 on success, nonzero on bad input (row/col out of range).
int mpp_csr_template(int64_t n_rows, int64_t n_cols, int64_t ncoo,
                     const int64_t* rows, const int64_t* cols,
                     int32_t* indptr, int32_t* indices_out,
                     int32_t* slots_out, int64_t* nnz_out) {
  std::vector<int64_t> keys(static_cast<size_t>(ncoo));
  for (int64_t i = 0; i < ncoo; ++i) {
    if (rows[i] < 0 || rows[i] >= n_rows || cols[i] < 0 || cols[i] >= n_cols)
      return 1;
    keys[static_cast<size_t>(i)] = rows[i] * n_cols + cols[i];
  }
  std::vector<int64_t> order(static_cast<size_t>(ncoo));
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return keys[static_cast<size_t>(a)] < keys[static_cast<size_t>(b)];
  });

  // count unique keys
  int64_t nnz = 0;
  int64_t prev = -1;
  for (int64_t i = 0; i < ncoo; ++i) {
    int64_t k = keys[static_cast<size_t>(order[static_cast<size_t>(i)])];
    if (k != prev) { ++nnz; prev = k; }
  }
  *nnz_out = nnz;
  if (indices_out == nullptr) return 0;  // sizing pass

  std::memset(indptr, 0, sizeof(int32_t) * static_cast<size_t>(n_rows + 1));
  prev = -1;
  int64_t u = -1;
  for (int64_t i = 0; i < ncoo; ++i) {
    int64_t idx = order[static_cast<size_t>(i)];
    int64_t k = keys[static_cast<size_t>(idx)];
    if (k != prev) {
      ++u;
      prev = k;
      indices_out[u] = static_cast<int32_t>(k % n_cols);
      indptr[k / n_cols + 1] += 1;
    }
    slots_out[idx] = static_cast<int32_t>(u);
  }
  for (int64_t r = 0; r < n_rows; ++r) indptr[r + 1] += indptr[r];
  return 0;
}

// ---------------------------------------------------------------------------
// Structured-mesh internal connections (mpp_mesh_utils analog)
//
// idir: 1=x, 2=y, 3=z (CONN_IN_{X,Y,Z}_DIR ids minus offset handled by
// caller).  Cells are numbered cell = i + j*nx + k*nx*ny (fastest x), and
// the connection emission order is ii outer, jj, kk inner — both exactly
// as in util/mpp_mesh_utils.F90 ComputeInternalConnections:363-470, so the
// downstream scatter-add summation order (and hence float parity) matches
// the pure-Python generator.  Connection up->dn is cell -> cell+stride
// along idir.  Outputs sized nconn = (n_idir-1) * (product of other dims).
// Returns nconn; negative on bad idir.
int64_t mpp_structured_connections(int64_t nx, int64_t ny, int64_t nz,
                                   double dx, double dy, double dz,
                                   int32_t idir, int64_t* id_up,
                                   int64_t* id_dn, double* dist_up,
                                   double* dist_dn, double* area) {
  int64_t stride;
  double half, face;
  int64_t ni = nx, nj = ny, nk = nz;
  switch (idir) {
    case 1: stride = 1;       ni = nx - 1; half = dx * 0.5; face = dy * dz; break;
    case 2: stride = nx;      nj = ny - 1; half = dy * 0.5; face = dx * dz; break;
    case 3: stride = nx * ny; nk = nz - 1; half = dz * 0.5; face = dx * dy; break;
    default: return -1;
  }
  int64_t n = 0;
  for (int64_t i = 0; i < ni; ++i)
    for (int64_t j = 0; j < nj; ++j)
      for (int64_t k = 0; k < nk; ++k) {
        int64_t cell = i + j * nx + k * nx * ny;
        id_up[n] = cell;
        id_dn[n] = cell + stride;
        dist_up[n] = half;
        dist_dn[n] = half;
        area[n] = face;
        ++n;
      }
  return n;
}

// ---------------------------------------------------------------------------
// PETSc binary Vec codec (PetscViewer binary analog)
//
// Format: big-endian int32 classid (1211214), big-endian int32 n,
// n big-endian float64 values.  Multiple Vecs may be concatenated in one
// file; the caller tracks the offset.

static inline uint32_t bswap32(uint32_t v) {
  return ((v & 0xFF000000u) >> 24) | ((v & 0x00FF0000u) >> 8) |
         ((v & 0x0000FF00u) << 8) | ((v & 0x000000FFu) << 24);
}
static inline uint64_t bswap64(uint64_t v) {
  return (static_cast<uint64_t>(bswap32(static_cast<uint32_t>(v))) << 32) |
         bswap32(static_cast<uint32_t>(v >> 32));
}
static bool is_little_endian() {
  const uint32_t one = 1;
  return *reinterpret_cast<const uint8_t*>(&one) == 1;
}

static const int32_t kVecClassId = 1211214;

// Read the Vec at byte `offset`.  Pass data == nullptr to query the length:
// writes n to n_out and returns 0.  Returns nonzero on IO/format error.
int mpp_petsc_vec_read(const char* path, int64_t offset, double* data,
                       int64_t* n_out, int64_t* next_offset) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;
  if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
    std::fclose(f);
    return 2;
  }
  uint32_t hdr[2];
  if (std::fread(hdr, sizeof(uint32_t), 2, f) != 2) { std::fclose(f); return 3; }
  if (is_little_endian()) { hdr[0] = bswap32(hdr[0]); hdr[1] = bswap32(hdr[1]); }
  if (static_cast<int32_t>(hdr[0]) != kVecClassId) { std::fclose(f); return 4; }
  int64_t n = static_cast<int32_t>(hdr[1]);
  *n_out = n;
  if (next_offset) *next_offset = offset + 8 + 8 * n;
  if (data == nullptr) { std::fclose(f); return 0; }
  if (std::fread(data, sizeof(double), static_cast<size_t>(n), f) !=
      static_cast<size_t>(n)) {
    std::fclose(f);
    return 5;
  }
  if (is_little_endian()) {
    uint64_t* raw = reinterpret_cast<uint64_t*>(data);
    for (int64_t i = 0; i < n; ++i) raw[i] = bswap64(raw[i]);
  }
  std::fclose(f);
  return 0;
}

// Append (mode 'a') or truncate-write (mode 'w') one Vec.
int mpp_petsc_vec_write(const char* path, const double* data, int64_t n,
                        int32_t append) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return 1;
  uint32_t hdr[2] = {static_cast<uint32_t>(kVecClassId),
                     static_cast<uint32_t>(n)};
  std::vector<uint64_t> buf(static_cast<size_t>(n));
  std::memcpy(buf.data(), data, sizeof(double) * static_cast<size_t>(n));
  if (is_little_endian()) {
    hdr[0] = bswap32(hdr[0]);
    hdr[1] = bswap32(hdr[1]);
    for (int64_t i = 0; i < n; ++i)
      buf[static_cast<size_t>(i)] = bswap64(buf[static_cast<size_t>(i)]);
  }
  size_t ok = std::fwrite(hdr, sizeof(uint32_t), 2, f);
  ok += std::fwrite(buf.data(), sizeof(uint64_t), static_cast<size_t>(n), f);
  std::fclose(f);
  return ok == 2 + static_cast<size_t>(n) ? 0 : 2;
}

}  // extern "C"

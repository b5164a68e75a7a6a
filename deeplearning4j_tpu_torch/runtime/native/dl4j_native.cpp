// Native host-side data runtime (≡ the roles libnd4j + DataVec's native
// image pipeline play in the reference: record parsing, buffer conversion,
// batch assembly, async prefetch). The compute path runs on the device;
// this code feeds it from the host without holding the Python GIL (ctypes releases
// the GIL for the duration of each call, so the prefetch thread converts
// batches while Python dispatches device work).
//
// C ABI only — bound via ctypes (no pybind11 in this image).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// IDX (MNIST-family) parsing
// ---------------------------------------------------------------------------
// Reads an uncompressed IDX file. Returns malloc'd payload (caller frees via
// dl4j_free), fills dims[0..ndim). Returns nullptr on failure.
void* dl4j_idx_read(const char* path, int64_t* dims, int32_t* ndim,
                    int32_t* dtype_code) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  unsigned char hdr[4];
  if (fread(hdr, 1, 4, f) != 4 || hdr[0] != 0 || hdr[1] != 0) {
    fclose(f);
    return nullptr;
  }
  *dtype_code = hdr[2];
  int nd = hdr[3];
  *ndim = nd;
  int64_t total = 1;
  for (int i = 0; i < nd; i++) {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) { fclose(f); return nullptr; }
    dims[i] = ((int64_t)b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3];
    total *= dims[i];
  }
  size_t elem = (*dtype_code == 0x0D) ? 4 : (*dtype_code == 0x0E) ? 8 : 1;
  void* buf = malloc((size_t)total * elem);
  if (!buf) { fclose(f); return nullptr; }
  size_t got = fread(buf, elem, (size_t)total, f);
  fclose(f);
  if ((int64_t)got != total) { free(buf); return nullptr; }
  return buf;
}

void dl4j_free(void* p) { free(p); }

// ---------------------------------------------------------------------------
// Numeric CSV parsing (≡ datavec CSVRecordReader's hot path for all-numeric
// tables). Single pass, no allocation per field, GIL released by ctypes.
// ---------------------------------------------------------------------------
// First pass over a NUL-terminated buffer: number of data rows (after
// skip_rows, blank lines ignored) and columns of the first data row.
void dl4j_csv_dims(const char* buf, char delim, int32_t skip_rows,
                   int64_t* rows_out, int64_t* cols_out) {
  int64_t rows = 0, cols = 0;
  int32_t skipped = 0;
  const char* p = buf;
  while (*p) {
    const char* line = p;
    int64_t c = 1;
    while (*p && *p != '\n') {
      if (*p == delim) ++c;
      ++p;
    }
    int64_t linelen = p - line;
    if (*p) ++p;  // consume '\n'
    // skip counts PHYSICAL lines (matching the Python path, where the
    // csv module yields a row per line including blanks)
    if (skipped < skip_rows) { ++skipped; continue; }
    if (linelen == 0 || (linelen == 1 && line[0] == '\r')) continue;
    if (rows == 0) cols = c;
    ++rows;
  }
  *rows_out = rows;
  *cols_out = cols;
}

// Second pass: fill out[rows*cols] float32. A field parses as a number
// only when strtof consumes it EXACTLY (up to trailing spaces/'\r') —
// empty, partial ("1.5abc"), and out-of-bounds parses all become NaN, so
// the caller's NaN screen rejects files the Python float() path would
// raise on. Short rows pad with NaN; long rows truncate. Returns values
// written, or -1 if out would overflow.
int64_t dl4j_csv_parse(const char* buf, char delim, int32_t skip_rows,
                       int64_t rows, int64_t cols, float* out) {
  int32_t skipped = 0;
  int64_t r = 0, written = 0;
  const char* p = buf;
  while (*p && r < rows) {
    const char* line = p;
    while (*p && *p != '\n') ++p;
    int64_t linelen = p - line;
    const char* line_end = p;
    if (*p) ++p;
    if (skipped < skip_rows) { ++skipped; continue; }
    if (linelen == 0 || (linelen == 1 && line[0] == '\r')) continue;
    const char* q = line;
    for (int64_t c = 0; c < cols; ++c) {
      if (written >= rows * cols) return -1;
      float v = __builtin_nanf("");
      if (q <= line_end) {
        // bound the field FIRST: strtof treats tabs/spaces as leading
        // whitespace, so an empty whitespace-delimited field would
        // otherwise swallow the next field's (or line's) number
        const char* fe = q;
        while (fe < line_end && *fe != delim) ++fe;
        const char* te = fe;
        while (te > q && (te[-1] == ' ' || te[-1] == '\r')) --te;
        if (te > q) {
          // reject C99 hex floats: strtof accepts "0x1A" but Python's
          // float() raises, and strict parity is the whole contract
          const char* h = q;
          while (h < te && (*h == ' ' || *h == '\t')) ++h;
          if (h < te && (*h == '+' || *h == '-')) ++h;
          bool hex = (h + 1 < te && h[0] == '0'
                      && (h[1] == 'x' || h[1] == 'X'));
          if (!hex) {
            char* endp = nullptr;
            float parsed = strtof(q, &endp);
            if (endp > q && endp == te) v = parsed;  // exact consume only
          }
        }
        q = (fe < line_end) ? fe + 1 : line_end + 1;
      }
      out[written++] = v;
    }
    ++r;
  }
  return written;
}

// ---------------------------------------------------------------------------
// Buffer conversion / batch assembly
// ---------------------------------------------------------------------------
// uint8 -> float32 with affine scale: dst = src * scale + bias
void dl4j_u8_to_f32(const uint8_t* src, float* dst, int64_t n, float scale,
                    float bias) {
  for (int64_t i = 0; i < n; i++) dst[i] = (float)src[i] * scale + bias;
}

// Gather `batch` items of `item_size` bytes from a uint8 archive into a
// float32 batch buffer with scaling — one call assembles a whole minibatch
// (≡ DataVec's RecordReaderDataSetIterator hot loop, natively).
void dl4j_gather_batch_u8(const uint8_t* src, int64_t item_size,
                          const int64_t* indices, int64_t batch, float* dst,
                          float scale, float bias) {
  for (int64_t b = 0; b < batch; b++) {
    const uint8_t* item = src + indices[b] * item_size;
    float* out = dst + b * item_size;
    for (int64_t i = 0; i < item_size; i++)
      out[i] = (float)item[i] * scale + bias;
  }
}

// One-hot encode int labels into a float32 matrix (batch, n_classes).
void dl4j_one_hot(const uint8_t* labels, const int64_t* indices,
                  int64_t batch, int64_t n_classes, float* dst) {
  memset(dst, 0, sizeof(float) * (size_t)batch * n_classes);
  for (int64_t b = 0; b < batch; b++)
    dst[b * n_classes + labels[indices[b]]] = 1.0f;
}

// Channel-mean subtraction in-place on a float32 NHWC batch (vgg-style).
void dl4j_sub_channel_means(float* data, int64_t n_pixels, int64_t channels,
                            const float* means) {
  for (int64_t p = 0; p < n_pixels; p++)
    for (int64_t c = 0; c < channels; c++) data[p * channels + c] -= means[c];
}

// Standardize columns in-place: (x - mean) / std over a (rows, cols) f32.
void dl4j_standardize(float* data, int64_t rows, int64_t cols,
                      const float* mean, const float* std) {
  for (int64_t r = 0; r < rows; r++) {
    float* row = data + r * cols;
    for (int64_t c = 0; c < cols; c++) row[c] = (row[c] - mean[c]) / std[c];
  }
}

// ---------------------------------------------------------------------------
// Async prefetch ring (≡ AsyncDataSetIterator's workspace-backed queue).
// The producer thread runs a registered C callback? No — Python drives
// production; the ring just provides a bounded, lock-protected handoff of
// opaque buffers so the conversion work above can happen off the consumer's
// critical path.
// ---------------------------------------------------------------------------
struct Ring {
  std::queue<std::pair<void*, int64_t>> q;
  std::mutex m;
  std::condition_variable cv_push, cv_pop;
  size_t capacity;
  std::atomic<bool> closed{false};
};

void* dl4j_ring_create(int64_t capacity) {
  Ring* r = new Ring();
  r->capacity = (size_t)capacity;
  return r;
}

// Blocks while full. Returns 0 on success, -1 if closed.
int32_t dl4j_ring_push(void* ring, void* buf, int64_t len) {
  Ring* r = (Ring*)ring;
  std::unique_lock<std::mutex> lk(r->m);
  r->cv_push.wait(lk, [&] { return r->q.size() < r->capacity || r->closed; });
  if (r->closed) return -1;
  r->q.push({buf, len});
  r->cv_pop.notify_one();
  return 0;
}

// Blocks while empty. Returns length, fills *buf; -1 if closed+drained.
int64_t dl4j_ring_pop(void* ring, void** buf) {
  Ring* r = (Ring*)ring;
  std::unique_lock<std::mutex> lk(r->m);
  r->cv_pop.wait(lk, [&] { return !r->q.empty() || r->closed; });
  if (r->q.empty()) return -1;
  auto item = r->q.front();
  r->q.pop();
  r->cv_push.notify_one();
  *buf = item.first;
  return item.second;
}

int64_t dl4j_ring_size(void* ring) {
  Ring* r = (Ring*)ring;
  std::lock_guard<std::mutex> lk(r->m);
  return (int64_t)r->q.size();
}

void dl4j_ring_close(void* ring) {
  Ring* r = (Ring*)ring;
  {
    std::lock_guard<std::mutex> lk(r->m);
    r->closed = true;
  }
  r->cv_pop.notify_all();
  r->cv_push.notify_all();
}

void dl4j_ring_destroy(void* ring) {
  Ring* r = (Ring*)ring;
  dl4j_ring_close(ring);
  while (!r->q.empty()) { free(r->q.front().first); r->q.pop(); }
  delete r;
}

// ---------------------------------------------------------------------------
// Host staging arena (≡ libnd4j MemoryWorkspace for host buffers): bump
// allocator with epoch reset — batch staging without per-batch malloc/free.
// ---------------------------------------------------------------------------
struct Arena {
  char* base;
  size_t capacity;
  std::atomic<size_t> offset{0};
};

void* dl4j_arena_create(int64_t capacity) {
  Arena* a = new Arena();
  a->base = (char*)malloc((size_t)capacity);
  a->capacity = (size_t)capacity;
  return a;
}

void* dl4j_arena_alloc(void* arena, int64_t size) {
  Arena* a = (Arena*)arena;
  size_t aligned = ((size_t)size + 63) & ~(size_t)63;
  size_t off = a->offset.fetch_add(aligned);
  if (off + aligned > a->capacity) return nullptr;  // caller falls back
  return a->base + off;
}

void dl4j_arena_reset(void* arena) { ((Arena*)arena)->offset = 0; }

int64_t dl4j_arena_used(void* arena) {
  return (int64_t)((Arena*)arena)->offset.load();
}

void dl4j_arena_destroy(void* arena) {
  Arena* a = (Arena*)arena;
  free(a->base);
  delete a;
}


// -- image ops (≡ datavec-data-image :: loader.NativeImageLoader — the
// reference resizes via native JavaCV/OpenCV; hand-rolled here, zero
// deps) -----------------------------------------------------------------
// Half-pixel-center bilinear (align_corners=False), u8 HWC -> f32 HWC in
// [0, 255]. Matches the numpy oracle in runtime/native_lib.py bit-for-bit
// in float32 (same clamp, same lerp order) — the strict-parity gate
// depends on that.
void dl4j_resize_bilinear_u8(const uint8_t* src, int64_t sh, int64_t sw,
                             int64_t c, float* dst, int64_t dh,
                             int64_t dw) {
  const float scale_y = (float)sh / (float)dh;
  const float scale_x = (float)sw / (float)dw;
  for (int64_t oy = 0; oy < dh; oy++) {
    float fy = ((float)oy + 0.5f) * scale_y - 0.5f;
    float fy0 = floorf(fy);
    float wy = fy - fy0;
    int64_t y0 = (int64_t)fy0;
    int64_t y0c = y0 < 0 ? 0 : (y0 >= sh ? sh - 1 : y0);
    int64_t y1 = y0 + 1;
    int64_t y1c = y1 < 0 ? 0 : (y1 >= sh ? sh - 1 : y1);
    for (int64_t ox = 0; ox < dw; ox++) {
      float fx = ((float)ox + 0.5f) * scale_x - 0.5f;
      float fx0 = floorf(fx);
      float wx = fx - fx0;
      int64_t x0 = (int64_t)fx0;
      int64_t x0c = x0 < 0 ? 0 : (x0 >= sw ? sw - 1 : x0);
      int64_t x1 = x0 + 1;
      int64_t x1c = x1 < 0 ? 0 : (x1 >= sw ? sw - 1 : x1);
      const uint8_t* r0 = src + (y0c * sw) * c;
      const uint8_t* r1 = src + (y1c * sw) * c;
      float* o = dst + (oy * dw + ox) * c;
      for (int64_t ch = 0; ch < c; ch++) {
        float v00 = (float)r0[x0c * c + ch];
        float v01 = (float)r0[x1c * c + ch];
        float v10 = (float)r1[x0c * c + ch];
        float v11 = (float)r1[x1c * c + ch];
        float top = v00 + (v01 - v00) * wx;
        float bot = v10 + (v11 - v10) * wx;
        o[ch] = top + (bot - top) * wy;
      }
    }
  }
}


}  // extern "C"

// Native host-side runtime for ssqueeze_rs_tpu.
//
// The reference's native layer is a Rust/Rayon transform core
// (rust/src/spectral/*) plus dask/pyarrow ingestion. Here the transforms
// live in XLA on the device; the native layer that remains host-side is:
//
//   1. a memory-mapped chunked signal reader with halo overlap — the
//      streaming feeder for sharded long-recording pipelines (replaces the
//      dask map_overlap ingestion in reference tests/stft_test.py:262-269),
//   2. OpenMP column-parallel fused reassignment kernels — a CPU oracle /
//      fallback mirroring the behavior of the reference's numba/Rust hot
//      loops (old/ssqueezepy/algos.py:859-984, rust/src/spectral/ssq_cwt.rs)
//      without copying their code,
//   3. TKEO kernels (reference test.rs:10-177).
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).
//
// Build: make -C native   (produces libssq_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(_OPENMP)
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// 1. Memory-mapped chunked reader with halo overlap
// ---------------------------------------------------------------------------
struct MappedSignal {
    int fd;
    void* base;
    size_t bytes;
    int64_t n_channels;   // channel-major layout: [channel][sample]
    int64_t n_samples;
    int32_t dtype_code;   // 0 = float32, 1 = float64
};

// Open a raw binary recording (channel-major). Returns handle or null.
MappedSignal* ssq_open(const char* path, int64_t n_channels,
                       int32_t dtype_code) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    struct stat st;
    if (fstat(fd, &st) != 0) { ::close(fd); return nullptr; }
    size_t bytes = static_cast<size_t>(st.st_size);
    void* base = mmap(nullptr, bytes, PROT_READ, MAP_PRIVATE, fd, 0);
    if (base == MAP_FAILED) { ::close(fd); return nullptr; }
    madvise(base, bytes, MADV_SEQUENTIAL);

    auto* h = new MappedSignal();
    h->fd = fd;
    h->base = base;
    h->bytes = bytes;
    h->n_channels = n_channels;
    h->dtype_code = dtype_code;
    size_t elem = (dtype_code == 0) ? 4 : 8;
    h->n_samples = static_cast<int64_t>(bytes / elem / n_channels);
    return h;
}

int64_t ssq_n_samples(MappedSignal* h) { return h ? h->n_samples : -1; }

void ssq_close(MappedSignal* h) {
    if (!h) return;
    munmap(h->base, h->bytes);
    ::close(h->fd);
    delete h;
}

// Fill `out[n_channels][halo_left + chunk_len + halo_right]` (float32) with
// chunk `start..start+chunk_len` plus halos; out-of-range regions are
// reflect-padded (matching dask map_overlap boundary='reflect' and our
// shard_map edge handling). Parallel over channels.
int ssq_read_chunk_f32(MappedSignal* h, int64_t start, int64_t chunk_len,
                       int64_t halo_left, int64_t halo_right, float* out) {
    if (!h || h->dtype_code != 0) return -1;
    const float* data = static_cast<const float*>(h->base);
    const int64_t N = h->n_samples;
    const int64_t ext = halo_left + chunk_len + halo_right;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t c = 0; c < h->n_channels; ++c) {
        const float* ch = data + c * N;
        float* dst = out + c * ext;
        for (int64_t i = 0; i < ext; ++i) {
            int64_t src = start - halo_left + i;
            // reflect (no edge repeat), REPEATED for halos wider than
            // the recording — np.pad(mode='reflect') semantics, same
            // mapping as io._reflect_indices
            if (N == 1) { dst[i] = ch[0]; continue; }
            const int64_t period = 2 * (N - 1);
            src = src < 0 ? -src : src;
            src %= period;
            if (src >= N) src = period - src;
            dst[i] = ch[src];
        }
    }
    return 0;
}

// ---------------------------------------------------------------------------
// 1b. Double-buffered prefetching chunk scheduler
//
// A producer thread reads + reflect-pads chunks into a ring of
// pre-allocated buffers while the consumer (the device feed) processes the
// previous one — the host-IO/device-compute overlap the reference gets
// from dask's threaded scheduler. Single consumer; the slot returned by
// ssq_prefetch_next is recycled on the NEXT call.
// ---------------------------------------------------------------------------
}  // extern "C"  (std::thread members below; C ABI resumes after)

#include <condition_variable>
#include <mutex>
#include <thread>
#include <vector>

struct Prefetcher {
    MappedSignal* h;
    int64_t chunk_len, halo, n_chunks;
    int32_t depth;
    size_t slot_elems;
    std::vector<float> pool;          // depth * n_channels * max_ext
    std::vector<int64_t> slot_chunk;  // which chunk sits in each slot
    std::vector<int> state;           // 0 = free, 1 = full
    int64_t next_fill = 0;            // producer's next chunk index
    int64_t next_emit = 0;            // consumer's next chunk index
    int64_t held_slot = -1;           // slot loaned to the consumer
    bool stop = false;
    int consumers_inside = 0;         // ssq_prefetch_next re-entrancy count
    std::mutex mu;
    std::condition_variable cv_full, cv_free, cv_drained;
    std::thread worker;
};

static void prefetch_loop(Prefetcher* p) {
    while (true) {
        int slot = -1;
        int64_t chunk;
        {
            std::unique_lock<std::mutex> lk(p->mu);
            p->cv_free.wait(lk, [&] {
                if (p->stop || p->next_fill >= p->n_chunks) return true;
                for (int s = 0; s < p->depth; ++s)
                    if (p->state[s] == 0 && s != p->held_slot) return true;
                return false;
            });
            if (p->stop || p->next_fill >= p->n_chunks) return;
            for (int s = 0; s < p->depth; ++s)
                if (p->state[s] == 0 && s != p->held_slot) { slot = s; break; }
            chunk = p->next_fill++;
        }
        const int64_t start = chunk * p->chunk_len;
        const int64_t cl = std::min(p->chunk_len, p->h->n_samples - start);
        ssq_read_chunk_f32(p->h, start, cl, p->halo, p->halo,
                           p->pool.data() + (size_t)slot * p->slot_elems);
        {
            std::lock_guard<std::mutex> lk(p->mu);
            p->slot_chunk[slot] = chunk;
            p->state[slot] = 1;
        }
        p->cv_full.notify_one();
    }
}

extern "C" {

Prefetcher* ssq_prefetch_start(MappedSignal* h, int64_t chunk_len,
                               int64_t halo, int32_t depth) {
    if (!h || h->dtype_code != 0 || chunk_len <= 0 || depth < 2)
        return nullptr;
    auto* p = new Prefetcher();
    p->h = h;
    p->chunk_len = chunk_len;
    p->halo = halo;
    p->depth = depth;
    p->n_chunks = (h->n_samples + chunk_len - 1) / chunk_len;
    p->slot_elems =
        (size_t)h->n_channels * (size_t)(chunk_len + 2 * halo);
    p->pool.resize((size_t)depth * p->slot_elems);
    p->slot_chunk.assign(depth, -1);
    p->state.assign(depth, 0);
    p->worker = std::thread(prefetch_loop, p);
    return p;
}

// Blocks until the in-order next chunk is ready. Returns its start sample
// (or -1 when the recording is exhausted); writes the buffer pointer and
// the chunk's core length. The buffer stays valid until the next call.
int64_t ssq_prefetch_next(Prefetcher* p, float** buf_out, int64_t* len_out) {
    if (!p) return -1;
    std::unique_lock<std::mutex> lk(p->mu);
    // presence counter: ssq_prefetch_stop waits for it to drain before
    // deleting p, so a consumer woken by a concurrent stop can finish
    // touching p safely (no use-after-free)
    struct Presence {
        Prefetcher* p;
        ~Presence() {
            if (--p->consumers_inside == 0) p->cv_drained.notify_all();
        }
    } presence{p};
    p->consumers_inside++;
    if (p->stop) return -1;
    if (p->held_slot >= 0) {          // recycle the loaned slot
        p->state[p->held_slot] = 0;
        p->held_slot = -1;
        p->cv_free.notify_one();
    }
    if (p->next_emit >= p->n_chunks) return -1;
    const int64_t want = p->next_emit;
    int slot = -1;
    p->cv_full.wait(lk, [&] {
        if (p->stop) return true;  // concurrent stop: unblock, don't deadlock
        for (int s = 0; s < p->depth; ++s)
            if (p->state[s] == 1 && p->slot_chunk[s] == want) {
                slot = s;
                return true;
            }
        return false;
    });
    if (p->stop && slot < 0) return -1;
    p->next_emit++;
    p->held_slot = slot;
    const int64_t start = want * p->chunk_len;
    *buf_out = p->pool.data() + (size_t)slot * p->slot_elems;
    *len_out = std::min(p->chunk_len, p->h->n_samples - start);
    return start;
}

// A consumer blocked in _next when stop fires is woken and returns -1;
// stop waits for all in-flight _next calls to drain (consumers_inside)
// before deleting p. Callers must not issue NEW _next calls after stop
// begins.
void ssq_prefetch_stop(Prefetcher* p) {
    if (!p) return;
    {
        std::lock_guard<std::mutex> lk(p->mu);
        p->stop = true;
    }
    p->cv_free.notify_all();
    p->cv_full.notify_all();  // release any consumer blocked in _next
    if (p->worker.joinable()) p->worker.join();
    {
        std::unique_lock<std::mutex> lk(p->mu);
        p->cv_drained.wait(lk, [&] { return p->consumers_inside == 0; });
    }
    delete p;
}

// ---------------------------------------------------------------------------
// 2. Fused reassignment kernels (CPU oracle / fallback)
//    Column-parallel — preserves the reference's race-free invariant
//    (scatter writes are column-local; algos.py:183-192).
// ---------------------------------------------------------------------------
static inline double round_half_even(double v) {
    return std::nearbyint(v);  // FE_TONEAREST = banker's rounding
}

// mode: 0 = log, 1 = log-piecewise, 2 = linear. Complex interleaved (re,im).
void ssq_reassign_f64(const double* wx, const double* dwx,
                      const double* sfs, const double* consts, int64_t na,
                      int64_t n, int64_t nf, int32_t mode, int32_t is_stft,
                      int32_t flipud, double gamma, double p0, double p1,
                      double p2, double p3, int64_t idx1, double* out) {
    const double TWO_PI = 6.283185307179586;
    const int64_t omax = nf - 1;

#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t j = 0; j < n; ++j) {
        for (int64_t i = 0; i < na; ++i) {
            const double C = wx[2 * (i * n + j)];
            const double D = wx[2 * (i * n + j) + 1];
            if (C * C + D * D <= gamma * gamma) continue;
            const double A = dwx[2 * (i * n + j)];
            const double B = dwx[2 * (i * n + j) + 1];
            double w = (B * C - A * D) / ((C * C + D * D) * TWO_PI);
            w = is_stft ? std::fabs(sfs[i] - w) : std::fabs(w);

            int64_t k;
            if (mode == 0) {           // log: p0=vlmin, p1=dvl
                double kv = round_half_even(
                    std::max((std::log2(w) - p0) / p1, 0.0));
                k = static_cast<int64_t>(std::min(kv, (double)omax));
            } else if (mode == 1) {    // log-piecewise: p0..p3 + idx1
                double wl = std::log2(w);
                if (wl > p1) {
                    double kv = round_half_even((wl - p1) / p3) + (double)idx1;
                    k = static_cast<int64_t>(std::min(kv, (double)omax));
                } else {
                    double kv = std::max(round_half_even((wl - p0) / p2), 0.0);
                    k = static_cast<int64_t>(kv);
                }
            } else {                   // linear: p0=vmin, p1=dv
                double kv = round_half_even(std::max((w - p0) / p1, 0.0));
                k = static_cast<int64_t>(std::min(kv, (double)omax));
            }
            if (flipud) k = omax - k;
            out[2 * (k * n + j)] += C * consts[i];
            out[2 * (k * n + j) + 1] += D * consts[i];
        }
    }
}

// ---------------------------------------------------------------------------
// 3. TKEO (reference test.rs:10-177), channel-parallel
// ---------------------------------------------------------------------------
void ssq_tkeo_f32(const float* x, int64_t n_channels, int64_t n,
                  float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t c = 0; c < n_channels; ++c) {
        const float* ch = x + c * n;
        float* dst = out + c * (n - 2);
        for (int64_t i = 1; i + 1 < n; ++i)
            dst[i - 1] = ch[i] * ch[i] - ch[i - 1] * ch[i + 1];
    }
}

void ssq_tkeo_mod_f32(const float* x, int64_t n_channels, int64_t n,
                      float* out) {
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
    for (int64_t c = 0; c < n_channels; ++c) {
        const float* ch = x + c * n;
        float* dst = out + c * (n - 3);
        for (int64_t i = 3; i < n; ++i)
            dst[i - 3] = ch[i - 1] * ch[i - 2] - ch[i] * ch[i - 3];
    }
}

}  // extern "C"

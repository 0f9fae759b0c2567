// Copied from native/vampomi_native.cpp, its CPython wrappers (:251-454) replaced by plain extern "C" entry points.
//
// The port's native IO runtime (vampomi_tpu_torch/io/native.py loads it with
// ctypes; ops/_build.py builds it with the host C++ compiler at first use).
// Counterpart of the reference's C++ IO layer (MPI-IO slab reads/writes,
// utilities.cpp:241-267 and the chunked collective templates
// utilities.hpp:70-124; positional fixed-width CSV rows utilities.cpp:366-401).
// MPI is replaced by per-process pread/pwrite into one shared file: each rank
// touches only its own byte range, which is what the reference's
// MPI_File_set_view achieved.
//
// Entry points (each returns 0 on success, else -1 with a message in err):
//   read_into(path, buffer, n_bytes, file_byte_offset, err, err_len)
//   read_f64_as_f32(path, f32_buffer, n_values, file_byte_offset, err, err_len)
//   read_f64_as_f32_stats(path, f32_buffer, n_rows, n_cols, file_byte_offset,
//                         mave, sumsq, err, err_len)
//   write_from(path, buffer, n_bytes, file_byte_offset, err, err_len)
//   write_csv_row(path, iteration, values, n_values, err, err_len)
// and format_csv_row(iteration, values, n_values, out, out_len), which
// returns the row's length (or -1 when out is too small).
//
// A read of 128 MiB or more is split over worker threads (one per 64 MiB, at
// most 16 and at most the host's cores), each with its own pread
// (thread-safe, offset-explicit); a shorter read is one pread.  The ingest
// reads 16 MiB chunks, each by one pread, several at once on its own thread
// pool (dataset.py): ctypes releases the interpreter lock for the call.
// read_f64_as_f32(_stats) narrow to f32 in flight (the JAX package's fused
// ingest); the port's loader does not route through them (ROADMAP.md).

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr size_t kChunkBytes = 8ull << 20;  // 8 MiB streaming chunks

int open_read(const char* path, std::string* err) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) *err = std::string("open('") + path + "') failed: " + strerror(errno);
    return fd;
}

// Fully read [offset, offset+len) into dst; returns false + err on failure.
bool pread_all(int fd, char* dst, size_t len, off_t offset, std::string* err) {
    size_t done = 0;
    while (done < len) {
        ssize_t r = ::pread(fd, dst + done, len - done, offset + (off_t)done);
        if (r < 0) {
            if (errno == EINTR) continue;
            *err = std::string("pread failed: ") + strerror(errno);
            return false;
        }
        if (r == 0) {
            *err = "pread hit EOF before reading requested range";
            return false;
        }
        done += (size_t)r;
    }
    return true;
}

bool pwrite_all(int fd, const char* src, size_t len, off_t offset, std::string* err) {
    size_t done = 0;
    while (done < len) {
        ssize_t w = ::pwrite(fd, src + done, len - done, offset + (off_t)done);
        if (w < 0) {
            if (errno == EINTR) continue;
            *err = std::string("pwrite failed: ") + strerror(errno);
            return false;
        }
        done += (size_t)w;
    }
    return true;
}

size_t pick_threads(size_t total_bytes) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    size_t by_size = std::max<size_t>(1, total_bytes / (64ull << 20));  // 1 per 64 MiB
    return std::min<size_t>(hw, std::min<size_t>(by_size, 16));
}

// Parallel raw read into dst.
bool parallel_read(const char* path, char* dst, size_t len, off_t offset,
                   std::string* err) {
    size_t nthreads = pick_threads(len);
    if (nthreads <= 1) {
        int fd = open_read(path, err);
        if (fd < 0) return false;
        bool ok = pread_all(fd, dst, len, offset, err);
        ::close(fd);
        return ok;
    }
    std::vector<std::thread> threads;
    std::vector<std::string> errs(nthreads);
    std::vector<char> oks(nthreads, 1);  // NOT vector<bool>: bit-packed RMW races across threads
    size_t per = (len + nthreads - 1) / nthreads;
    for (size_t t = 0; t < nthreads; t++) {
        size_t lo = t * per;
        size_t hi = std::min(len, lo + per);
        if (lo >= hi) break;
        threads.emplace_back([&, t, lo, hi]() {
            int fd = open_read(path, &errs[t]);
            if (fd < 0) { oks[t] = 0; return; }
            oks[t] = pread_all(fd, dst + lo, hi - lo, offset + (off_t)lo, &errs[t]) ? 1 : 0;
            ::close(fd);
        });
    }
    for (auto& th : threads) th.join();
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

// Streamed f64 -> f32 narrowing read: one worker per contiguous range, each
// with its own chunk buffer.
bool parallel_read_f64_as_f32(const char* path, float* dst, size_t n_doubles,
                              off_t offset, std::string* err) {
    size_t total_bytes = n_doubles * 8;
    size_t nthreads = pick_threads(total_bytes);
    size_t per_vals = (n_doubles + nthreads - 1) / nthreads;

    std::vector<std::thread> threads;
    std::vector<std::string> errs(std::max<size_t>(nthreads, 1));
    std::vector<char> oks(std::max<size_t>(nthreads, 1), 1);  // NOT vector<bool>: bit-packed RMW races

    auto work = [&](size_t t, size_t lo, size_t hi) {
        int fd = open_read(path, &errs[t]);
        if (fd < 0) { oks[t] = 0; return; }
        std::vector<double> buf(std::min(kChunkBytes / 8, hi - lo));
        size_t pos = lo;
        while (pos < hi) {
            size_t cnt = std::min(buf.size(), hi - pos);
            if (!pread_all(fd, (char*)buf.data(), cnt * 8,
                           offset + (off_t)(pos * 8), &errs[t])) {
                oks[t] = 0;
                ::close(fd);
                return;
            }
            float* out = dst + pos;
            for (size_t i = 0; i < cnt; i++) out[i] = (float)buf[i];
            pos += cnt;
        }
        ::close(fd);
    };

    if (nthreads <= 1) {
        work(0, 0, n_doubles);
    } else {
        for (size_t t = 0; t < nthreads; t++) {
            size_t lo = t * per_vals;
            size_t hi = std::min(n_doubles, lo + per_vals);
            if (lo >= hi) break;
            threads.emplace_back(work, t, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

// Fused streamed ingest + per-marker standardization statistics.  The
// reference computes marker mean / inverse-sd in a separate native
// OpenMP+SIMD pass after the collective read (src/data.cpp:233-283); here
// the f64 -> f32 narrowing read and the f64 statistics share one pass over
// the file, so loading never re-reads the matrix from host memory.  Threads
// split on whole marker rows so each row's statistics have a single owner;
// per row: sequential f64 sum -> mean, then centered sum of squares (the
// same two-pass formula as the numpy fallback).
bool parallel_read_f64_as_f32_stats(const char* path, float* dst,
                                    size_t n_rows, size_t n_cols,
                                    off_t offset, double* mave, double* sumsq,
                                    std::string* err) {
    if (n_cols == 0) { *err = "n_cols must be positive"; return false; }
    if (n_rows == 0) return true;  // empty slab: nothing to read or compute
    size_t total_bytes = n_rows * n_cols * 8;
    size_t nthreads = std::min(pick_threads(total_bytes), n_rows);
    size_t per_rows = (n_rows + nthreads - 1) / nthreads;

    std::vector<std::thread> threads;
    std::vector<std::string> errs(std::max<size_t>(nthreads, 1));
    std::vector<char> oks(std::max<size_t>(nthreads, 1), 1);

    auto work = [&](size_t t, size_t rlo, size_t rhi) {
        int fd = open_read(path, &errs[t]);
        if (fd < 0) { oks[t] = 0; return; }
        size_t chunk_rows = std::max<size_t>(1, (kChunkBytes / 8) / n_cols);
        std::vector<double> buf(std::min(chunk_rows, rhi - rlo) * n_cols);
        for (size_t r = rlo; r < rhi; r += chunk_rows) {
            size_t rows = std::min(chunk_rows, rhi - r);
            if (!pread_all(fd, (char*)buf.data(), rows * n_cols * 8,
                           offset + (off_t)((r - 0) * n_cols * 8), &errs[t])) {
                oks[t] = 0;
                ::close(fd);
                return;
            }
            for (size_t i = 0; i < rows; i++) {
                const double* src = buf.data() + i * n_cols;
                float* out = dst + (r + i) * n_cols;
                double s = 0.0;
                for (size_t j = 0; j < n_cols; j++) {
                    s += src[j];
                    out[j] = (float)src[j];
                }
                double mean = s / (double)n_cols;
                double ss = 0.0;
                for (size_t j = 0; j < n_cols; j++) {
                    double d = src[j] - mean;
                    ss += d * d;
                }
                mave[r + i] = mean;
                sumsq[r + i] = ss;
            }
        }
        ::close(fd);
    };

    if (nthreads <= 1) {
        work(0, 0, n_rows);
    } else {
        for (size_t t = 0; t < nthreads; t++) {
            size_t lo = t * per_rows;
            size_t hi = std::min(n_rows, lo + per_rows);
            if (lo >= hi) break;
            threads.emplace_back(work, t, lo, hi);
        }
        for (auto& th : threads) th.join();
    }
    for (size_t t = 0; t < oks.size(); t++) {
        if (!oks[t]) { *err = errs[t]; return false; }
    }
    return true;
}

}  // namespace


// Format "%5d" + ", %20.15f"*k + "\n" with C printf semantics (the byte
// contract of reference utilities.cpp:366-385).
static void format_row(long iteration, const double* values, size_t n, std::string* out) {
    char buf[64];
    // snprintf returns the WOULD-BE length; clamp so a pathological value
    // (>63 rendered chars) cannot over-read the stack buffer
    int cx = snprintf(buf, sizeof(buf), "%5ld", iteration);
    cx = std::max(0, std::min(cx, (int)sizeof(buf) - 1));
    out->assign(buf, (size_t)cx);
    for (size_t i = 0; i < n; i++) {
        cx = snprintf(buf, sizeof(buf), ", %20.15f", values[i]);
        cx = std::max(0, std::min(cx, (int)sizeof(buf) - 1));
        out->append(buf, (size_t)cx);
    }
    out->push_back('\n');
}

static int report(bool ok, const std::string& msg, char* err, size_t err_len) {
    if (ok) return 0;
    if (err_len > 0) snprintf(err, err_len, "%s", msg.c_str());
    return -1;
}

static bool write_at(const char* path, const char* src, size_t len, off_t offset,
                     std::string* err) {
    int fd = ::open(path, O_WRONLY | O_CREAT, 0644);
    if (fd < 0) {
        *err = std::string("open('") + path + "') failed: " + strerror(errno);
        return false;
    }
    bool ok = pwrite_all(fd, src, len, offset, err);
    ::close(fd);
    return ok;
}

extern "C" {

int read_into(const char* path, void* buffer, uint64_t n_bytes, uint64_t offset,
              char* err, uint64_t err_len) {
    std::string msg;
    bool ok = parallel_read(path, (char*)buffer, (size_t)n_bytes, (off_t)offset, &msg);
    return report(ok, msg, err, err_len);
}

int read_f64_as_f32(const char* path, float* buffer, uint64_t n_values, uint64_t offset,
                    char* err, uint64_t err_len) {
    std::string msg;
    bool ok = parallel_read_f64_as_f32(path, buffer, (size_t)n_values, (off_t)offset, &msg);
    return report(ok, msg, err, err_len);
}

int read_f64_as_f32_stats(const char* path, float* buffer, uint64_t n_rows, uint64_t n_cols,
                          uint64_t offset, double* mave, double* sumsq, char* err,
                          uint64_t err_len) {
    std::string msg;
    bool ok = parallel_read_f64_as_f32_stats(path, buffer, (size_t)n_rows, (size_t)n_cols,
                                             (off_t)offset, mave, sumsq, &msg);
    return report(ok, msg, err, err_len);
}

// O_CREAT without O_TRUNC: ranks write disjoint slabs of one shared file
int write_from(const char* path, const void* buffer, uint64_t n_bytes, uint64_t offset,
               char* err, uint64_t err_len) {
    std::string msg;
    bool ok = write_at(path, (const char*)buffer, (size_t)n_bytes, (off_t)offset, &msg);
    return report(ok, msg, err, err_len);
}

int64_t format_csv_row(long iteration, const double* values, uint64_t n_values, char* out,
                       uint64_t out_len) {
    std::string row;
    format_row(iteration, values, (size_t)n_values, &row);
    if (row.size() > out_len) return -1;
    memcpy(out, row.data(), row.size());
    return (int64_t)row.size();
}

// positional offset: iteration * row length (reference utilities.cpp:383)
int write_csv_row(const char* path, long iteration, const double* values, uint64_t n_values,
                  char* err, uint64_t err_len) {
    std::string row, msg;
    format_row(iteration, values, (size_t)n_values, &row);
    bool ok = write_at(path, row.data(), row.size(), (off_t)iteration * (off_t)row.size(), &msg);
    return report(ok, msg, err, err_len);
}

}  // extern "C"

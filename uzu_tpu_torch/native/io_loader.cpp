// Parallel safetensors tensor reader, the port's copy of the JAX
// package's uzu_tpu/native/io_loader.cpp (the same C ABI, uz_read_parallel).
//
// The reference reads tensor bytes straight from the file into its
// allocations (crates/backend-uzu/src/parameters/loader.rs:192-213). Here
// the host fills its numpy buffers before they become torch tensors: this
// library fans pread(2) calls of all tensors out over a thread pool, where
// Python's per-tensor read loop is single-threaded.
//
// C ABI only, consumed via ctypes (uzu_tpu_torch/native/__init__.py builds
// it with g++ at first use).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

struct Job {
    uint64_t offset;
    uint64_t size;
    void* dest;
};

int read_job(int fd, const Job& job) {
    char* dst = static_cast<char*>(job.dest);
    uint64_t done = 0;
    while (done < job.size) {
        ssize_t n = pread(fd, dst + done, job.size - done,
                          static_cast<off_t>(job.offset + done));
        if (n < 0) {
            if (errno == EINTR) continue;
            return -errno;
        }
        if (n == 0) return -EIO;  // unexpected EOF
        done += static_cast<uint64_t>(n);
    }
    return 0;
}

}  // namespace

extern "C" {

// Reads n tensors from `path` concurrently. offsets/sizes/dests are
// parallel arrays; `threads` <= 0 picks the hardware concurrency.
// Returns 0 on success, or the first negative errno encountered.
int uz_read_parallel(const char* path, int n, const uint64_t* offsets,
                     const uint64_t* sizes, void** dests, int threads) {
    if (n <= 0) return 0;
    unsigned want = threads > 0 ? static_cast<unsigned>(threads)
                                : std::thread::hardware_concurrency();
    if (want == 0) want = 4;
    if (want > static_cast<unsigned>(n)) want = static_cast<unsigned>(n);

    std::atomic<int> next{0};
    std::atomic<int> status{0};
    std::vector<std::thread> pool;
    pool.reserve(want);
    for (unsigned t = 0; t < want; ++t) {
        pool.emplace_back([&]() {
            int fd = open(path, O_RDONLY);
            if (fd < 0) {
                int expected = 0;
                status.compare_exchange_strong(expected, -errno);
                return;
            }
            for (;;) {
                int i = next.fetch_add(1);
                if (i >= n || status.load() != 0) break;
                Job job{offsets[i], sizes[i], dests[i]};
                int rc = read_job(fd, job);
                if (rc != 0) {
                    int expected = 0;
                    status.compare_exchange_strong(expected, rc);
                    break;
                }
            }
            close(fd);
        });
    }
    for (auto& th : pool) th.join();
    return status.load();
}

}  // extern "C"

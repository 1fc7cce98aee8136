// Native shard I/O: bulk file <-> memory transfers for the shard container
// (storage/shard_format.py), the counterpart of the original system's
// zero-copy + io_uring layer (src/shards.rs):
//   * vix_write_file: write loop, then fsync (page-cache friendly for the
//     mmap read path).
//   * vix_read_file: pread loop into a caller buffer.
//   * vix_mmap_open / vix_mmap_close: zero-copy read mapping with
//     MADV_SEQUENTIAL | MADV_WILLNEED readahead for load-time staging.
//   * vix_file_size: stat helper.
//
// A plain C ABI, loaded with ctypes by shardio.py, which compiles this file
// with g++ at first use.

#include <cerrno>
#include <cstdint>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Returns 0 on success, -errno on failure.
int vix_write_file(const char* path, const uint8_t* data, uint64_t size) {
  int fd = ::open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  uint64_t off = 0;
  while (off < size) {
    ssize_t w = ::write(fd, data + off, size - off);
    if (w < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    off += static_cast<uint64_t>(w);
  }
  if (::fsync(fd) != 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  ::close(fd);
  return 0;
}

int64_t vix_file_size(const char* path) {
  struct stat st;
  if (::stat(path, &st) != 0) return -errno;
  return static_cast<int64_t>(st.st_size);
}

// Read up to `size` bytes at `offset` into `out`. Returns bytes read or
// -errno.
int64_t vix_read_file(const char* path, uint8_t* out, uint64_t offset, uint64_t size) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return -errno;
  uint64_t got = 0;
  while (got < size) {
    ssize_t r = ::pread(fd, out + got, size - got, static_cast<off_t>(offset + got));
    if (r < 0) {
      if (errno == EINTR) continue;
      int e = errno;
      ::close(fd);
      return -e;
    }
    if (r == 0) break;  // EOF
    got += static_cast<uint64_t>(r);
  }
  ::close(fd);
  return static_cast<int64_t>(got);
}

// Zero-copy mapping for load-time staging. Returns the mapping address (or
// nullptr, also for an empty file) and writes the size to *out_size. The
// kernel is told the access pattern, so readahead overlaps the parse and
// the copy to the device.
void* vix_mmap_open(const char* path, uint64_t* out_size) {
  *out_size = 0;
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (::fstat(fd, &st) != 0 || st.st_size == 0) {
    ::close(fd);
    return nullptr;
  }
  void* addr = ::mmap(nullptr, static_cast<size_t>(st.st_size), PROT_READ, MAP_PRIVATE, fd, 0);
  ::close(fd);  // the mapping keeps the file alive
  if (addr == MAP_FAILED) return nullptr;
  ::madvise(addr, static_cast<size_t>(st.st_size), MADV_SEQUENTIAL);
  ::madvise(addr, static_cast<size_t>(st.st_size), MADV_WILLNEED);
  *out_size = static_cast<uint64_t>(st.st_size);
  return addr;
}

int vix_mmap_close(void* addr, uint64_t size) {
  if (addr == nullptr) return 0;
  return ::munmap(addr, static_cast<size_t>(size)) == 0 ? 0 : -errno;
}

}  // extern "C"

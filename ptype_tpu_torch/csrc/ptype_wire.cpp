// Native wire transport for the actor RPC data plane — the port's copy
// of native/ptype_wire.cpp, unchanged but for these comments.
//
// The reference's data plane was Go net/rpc over TCP (gob encoding,
// cluster/rpc.go:277); its runtime was compiled Go. This is the
// equivalent native tier for the Python host runtime: frame
// assembly/teardown without byte-concatenation copies and without the
// GIL (ctypes releases it for the duration of every call).
//
//   frame := [4B big-endian header_len][header JSON][blob 0][blob 1]...
//
// - ptype_send_frame: one writev() per frame — the length prefix,
//   header, and every tensor blob go to the kernel as an iovec array,
//   so a 100 MB parameter push never materializes a second 100 MB
//   Python bytes object.
// - ptype_recv_exact: blocking read loop into a caller buffer
//   (numpy-allocated, so tensor bytes land where np.frombuffer will
//   read them — zero intermediate copies).
// - ptype_crc32c: software CRC-32C (Castagnoli) for optional payload
//   integrity on cross-host links.
//
// Built by g++ -O3 -fPIC -shared at first use, loaded via ctypes from
// ptype_tpu_torch/native.py with a pure-Python fallback when absent.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <sys/socket.h>
#include <sys/uio.h>
#include <unistd.h>

extern "C" {

// Send the whole frame with writev, handling partial writes. Returns 0
// on success, -errno on failure.
int ptype_send_frame(int fd, const uint8_t *header, uint64_t header_len,
                     const uint8_t **blobs, const uint64_t *blob_lens,
                     uint64_t nblobs) {
  uint8_t prefix[4] = {
      (uint8_t)(header_len >> 24), (uint8_t)(header_len >> 16),
      (uint8_t)(header_len >> 8), (uint8_t)(header_len)};

  const uint64_t niov = 2 + nblobs;
  if (niov > 1024) return -EINVAL;
  struct iovec iov[1024];
  iov[0].iov_base = prefix;
  iov[0].iov_len = 4;
  iov[1].iov_base = const_cast<uint8_t *>(header);
  iov[1].iov_len = header_len;
  for (uint64_t i = 0; i < nblobs; i++) {
    iov[2 + i].iov_base = const_cast<uint8_t *>(blobs[i]);
    iov[2 + i].iov_len = blob_lens[i];
  }

  uint64_t idx = 0;
  while (idx < niov) {
    // IOV_MAX is at least 1024 on Linux; chunk defensively anyway.
    int cnt = (int)(niov - idx > 512 ? 512 : niov - idx);
    ssize_t n = writev(fd, &iov[idx], cnt);
    if (n < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    uint64_t done = (uint64_t)n;
    while (done > 0 && idx < niov) {
      if (done >= iov[idx].iov_len) {
        done -= iov[idx].iov_len;
        idx++;
      } else {
        iov[idx].iov_base = (uint8_t *)iov[idx].iov_base + done;
        iov[idx].iov_len -= done;
        done = 0;
      }
    }
    // Skip zero-length iovecs (empty blobs).
    while (idx < niov && iov[idx].iov_len == 0) idx++;
  }
  return 0;
}

// Read exactly n bytes. Returns n on success, 0 on orderly EOF at
// offset 0, -errno on error, -1000000 on EOF mid-frame.
int64_t ptype_recv_exact(int fd, uint8_t *buf, uint64_t n) {
  uint64_t got = 0;
  while (got < n) {
    ssize_t r = recv(fd, buf + got, n - got, 0);
    if (r < 0) {
      if (errno == EINTR) continue;
      return -(int64_t)errno;
    }
    if (r == 0) return got == 0 ? 0 : -1000000;
    got += (uint64_t)r;
  }
  return (int64_t)got;
}

// Software CRC-32C (Castagnoli), byte-at-a-time table.
static uint32_t crc32c_table[256];
static bool crc32c_init_done = false;

static void crc32c_init() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    crc32c_table[i] = c;
  }
  crc32c_init_done = true;
}

uint32_t ptype_crc32c(const uint8_t *data, uint64_t len) {
  if (!crc32c_init_done) crc32c_init();
  uint32_t crc = 0xFFFFFFFFu;
  for (uint64_t i = 0; i < len; i++)
    crc = crc32c_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"

// Fast tar (webdataset shard) indexer.
//
// Scans a POSIX/GNU tar file and emits one line per regular-file entry:
//     "<name>\t<payload_offset>\t<size>\n"
// into a malloc'd buffer the caller frees with mm_free. Python groups entries by sample key
// (basename before the first dot — webdataset convention) and reads payloads by offset, so
// shard IO is two syscalls per sample instead of the tarfile module's Python-level header
// walk. Counterpart of the reference's webdataset tar streaming (AlignCLIP/main/data.py:
// 310-315 tarfile_to_samples_nothrow; group_by_keys in the webdataset dependency).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

int64_t parse_octal(const char* p, int n) {
  // GNU base-256 extension for sizes > 8GB
  if (static_cast<unsigned char>(p[0]) & 0x80) {
    int64_t v = static_cast<unsigned char>(p[0]) & 0x7F;
    for (int i = 1; i < n; ++i) v = (v << 8) | static_cast<unsigned char>(p[i]);
    return v;
  }
  int64_t v = 0;
  for (int i = 0; i < n && p[i]; ++i) {
    if (p[i] < '0' || p[i] > '7') continue;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

bool is_zero_block(const char* b) {
  for (int i = 0; i < 512; ++i)
    if (b[i]) return false;
  return true;
}

}  // namespace

extern "C" {

void mm_free(char* p) { std::free(p); }

// Returns a malloc'd index string (caller frees via mm_free), or nullptr on open failure.
// *out_len receives the string length.
char* mm_tar_index(const char* path, int64_t* out_len) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;

  std::string out;
  out.reserve(1 << 16);
  char hdr[512];
  std::string long_name;  // pending GNU 'L' long-name payload
  int64_t offset = 0;
  int zero_blocks = 0;

  while (std::fread(hdr, 1, 512, f) == 512) {
    offset += 512;
    if (is_zero_block(hdr)) {
      if (++zero_blocks >= 2) break;
      continue;
    }
    zero_blocks = 0;

    const int64_t size = parse_octal(hdr + 124, 12);
    const char type = hdr[156];
    const int64_t padded = (size + 511) & ~511LL;

    if (type == 'L') {  // GNU long name: payload is the next entry's name
      long_name.assign(padded, '\0');
      if (std::fread(long_name.data(), 1, padded, f) != static_cast<size_t>(padded)) break;
      long_name.resize(strnlen(long_name.c_str(), size));
      offset += padded;
      continue;
    }

    std::string name;
    if (!long_name.empty()) {
      name.swap(long_name);
    } else {
      char prefix[156] = {0};
      std::memcpy(prefix, hdr + 345, 155);  // ustar prefix field
      name.assign(hdr, strnlen(hdr, 100));
      if (prefix[0] && std::strncmp(hdr + 257, "ustar", 5) == 0) {
        name = std::string(prefix, strnlen(prefix, 155)) + "/" + name;
      }
    }

    if (type == '0' || type == '\0') {  // regular file
      out += name;
      out += '\t';
      out += std::to_string(offset);
      out += '\t';
      out += std::to_string(size);
      out += '\n';
    }
    if (std::fseek(f, padded, SEEK_CUR) != 0) break;
    offset += padded;
  }
  std::fclose(f);

  char* buf = static_cast<char*>(std::malloc(out.size() + 1));
  if (!buf) return nullptr;
  std::memcpy(buf, out.data(), out.size());
  buf[out.size()] = '\0';
  *out_len = static_cast<int64_t>(out.size());
  return buf;
}

}  // extern "C"

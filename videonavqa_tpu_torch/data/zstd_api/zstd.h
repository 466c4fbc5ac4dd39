/* The four functions of zstd's stable API that native/vnr.cpp calls, for a
 * machine that has the zstd runtime library (libzstd.so.1) but not its
 * development header. data/vnr.py puts this directory after the system's
 * include directories (-idirafter), so a system zstd.h takes precedence. */
#ifndef VIDEONAVQA_ZSTD_API_H
#define VIDEONAVQA_ZSTD_API_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

size_t ZSTD_compress(void* dst, size_t dstCapacity, const void* src, size_t srcSize,
                     int compressionLevel);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src, size_t compressedSize);
size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);

#ifdef __cplusplus
}
#endif

#endif

// pheniqs-tpu native host runtime: high-throughput FASTQ ingest.
//
// The host-side equivalent of the reference's htslib feed layer
// (reference fastq.h:30-456, feed.h:281-456): where the reference runs one
// pthread per feed filling ring buffers of Segment objects, this library
// parses (optionally gzip-compressed, via zlib) FASTQ streams directly
// into caller-provided SoA batch buffers — BAM 4-bit nucleotide codes,
// phred qualities, lengths, names, and the Illumina comment QC-fail flag —
// which the Python engine hands to the device as tensors.
//
// Exposed as a plain C ABI consumed through ctypes (no pybind11 in the
// image). All functions are thread-compatible: one handle per stream, no
// shared state.

#include <algorithm>
#include <cerrno>
#include <charconv>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

// ASCII -> BAM 4-bit nucleotide code ('=' 0, A 1, C 2, M 3, G 4, ... N 15),
// unknown bytes -> 15; mirrors pheniqs_tpu.iupac.ASCII_TO_BAM.
struct AsciiToBam {
    uint8_t table[256];
    AsciiToBam() {
        const char* alphabet = "=ACMGRSVTWYHKDBN";
        for (int i = 0; i < 256; ++i) table[i] = 15;
        for (int code = 0; code < 16; ++code) {
            unsigned char upper = static_cast<unsigned char>(alphabet[code]);
            table[upper] = static_cast<uint8_t>(code);
            table[std::tolower(upper)] = static_cast<uint8_t>(code);
        }
        table[static_cast<unsigned char>('=')] = 0;
        table[static_cast<unsigned char>('U')] = 8;
        table[static_cast<unsigned char>('u')] = 8;
    }
};
const AsciiToBam kAsciiToBam;

constexpr size_t kChunk = 1 << 20;

struct BgzfReader;  // defined below
static int64_t bgzf_read_helper(BgzfReader* reader, uint8_t* out, int64_t want);
static const char* bgzf_error_helper(BgzfReader* reader);

struct Reader {
    gzFile file = nullptr;
    BgzfReader* bgzf = nullptr;  // parallel block-decompress path when BGZF
    std::string buffer;   // decompressed carry-over
    size_t position = 0;  // consume offset into buffer
    bool eof = false;
    std::string error;
    int phred_offset = 33;

    // A parsed record longer than the batch matrix width is stashed here
    // (never silently clipped — reference handles arbitrary read lengths);
    // the caller grows max_length and retries, and the next read_batch call
    // emits it first.
    bool has_pending = false;
    std::string pending_name;
    std::string pending_sequence;  // raw ASCII
    std::string pending_quality;   // raw ASCII
    uint8_t pending_fail = 0;

    // Refill so that at least one full line is available; returns false on
    // EOF with an empty remainder.
    bool fill() {
        if (eof) return position < buffer.size();
        if (position > 0) {
            buffer.erase(0, position);
            position = 0;
        }
        size_t old = buffer.size();
        buffer.resize(old + kChunk);
        int64_t got;
        if (bgzf != nullptr) {
            got = bgzf_read_helper(
                bgzf, reinterpret_cast<uint8_t*>(&buffer[old]),
                static_cast<int64_t>(kChunk));
            if (got < 0) {
                error = bgzf_error_helper(bgzf);
                if (error.empty()) error = "BGZF read failed";
                buffer.resize(old);
                eof = true;
                return false;
            }
        } else {
            int zgot = gzread(file, &buffer[old], static_cast<unsigned>(kChunk));
            if (zgot < 0) {
                int errnum = 0;
                const char* message = gzerror(file, &errnum);
                error = message ? message : "gzread failed";
                buffer.resize(old);
                eof = true;
                return false;
            }
            got = zgot;
        }
        buffer.resize(old + static_cast<size_t>(got));
        if (static_cast<size_t>(got) < kChunk) eof = true;
        return buffer.size() > position;
    }

    // Returns pointer+length of the next line (without terminator), or
    // false at EOF. The returned span stays valid until the next fill().
    bool line(const char** out, size_t* length) {
        while (true) {
            size_t nl = buffer.find('\n', position);
            if (nl != std::string::npos) {
                size_t start = position;
                size_t len = nl - start;
                if (len > 0 && buffer[start + len - 1] == '\r') --len;
                position = nl + 1;
                *out = buffer.data() + start;
                *length = len;
                return true;
            }
            if (eof) {
                if (position < buffer.size()) {
                    size_t start = position;
                    size_t len = buffer.size() - start;
                    if (len > 0 && buffer[start + len - 1] == '\r') --len;
                    position = buffer.size();
                    *out = buffer.data() + start;
                    *length = len;
                    return true;
                }
                return false;
            }
            if (!fill() && eof && position >= buffer.size()) return false;
        }
    }
};

// --- parallel BGZF input ----------------------------------------------------
// BGZF (the block-gzip framing BAM and most genomics .gz files use) is a
// series of independent <=64KB gzip members, each carrying its compressed
// size in a 'BC' extra subfield — so decompression parallelizes perfectly.
// This is the ingest analog of the reference's htslib decompression thread
// pool (reference transcode.cpp:1599-1605); the reference names compressed
// input as the primary bottleneck (docs/configuration.md:20).
//
// One IO thread reads framed blocks into a slot ring; N inflate workers
// decompress any ready slot; the consumer drains slots strictly in order.

struct BgzfReader {
    static const int DEPTH = 32;
    struct Slot {
        std::vector<uint8_t> payload;  // raw deflate payload
        std::vector<uint8_t> raw;      // decompressed
        uint32_t crc = 0;
        uint32_t isize = 0;
        int state = 0;  // 0 free, 1 compressed ready, 2 claimed, 3 raw ready
    };
    Slot slots[DEPTH];
    std::mutex mu;
    std::condition_variable cv_work;   // workers wait for state-1 slots
    std::condition_variable cv_ready;  // consumer waits for its ordered slot
    std::condition_variable cv_free;   // io thread waits for a free slot
    long long produced = 0;  // blocks handed to the ring
    long long consumed = 0;  // blocks fully drained
    bool io_done = false;
    bool shutdown = false;
    std::string error;
    FILE* file = nullptr;
    std::thread io_thread;
    std::vector<std::thread> workers;
    size_t raw_pos = 0;  // consumer offset into the current ordered slot

    ~BgzfReader() { stop(); }

    void stop() {
        {
            std::lock_guard<std::mutex> lock(mu);
            shutdown = true;
        }
        cv_work.notify_all();
        cv_free.notify_all();
        cv_ready.notify_all();
        if (io_thread.joinable()) io_thread.join();
        for (auto& worker : workers)
            if (worker.joinable()) worker.join();
        if (file != nullptr) {
            fclose(file);
            file = nullptr;
        }
    }

    void fail(const std::string& message) {
        std::lock_guard<std::mutex> lock(mu);
        if (error.empty()) error = message;
        io_done = true;
        cv_ready.notify_all();
        cv_work.notify_all();
    }

    // Parse one BGZF member from `file` into (payload, crc, isize);
    // returns 1 on success, 0 on clean EOF, -1 on malformed input.
    int read_block(std::vector<uint8_t>& payload, uint32_t* crc, uint32_t* isize) {
        uint8_t header[12];
        size_t got = fread(header, 1, 12, file);
        if (got == 0) return 0;
        if (got < 12 || header[0] != 0x1F || header[1] != 0x8B || header[2] != 8 ||
            (header[3] & 4) == 0) {
            return -1;  // not a BGZF member
        }
        uint16_t xlen = static_cast<uint16_t>(header[10] | (header[11] << 8));
        std::vector<uint8_t> extra(xlen);
        if (fread(extra.data(), 1, xlen, file) != xlen) return -1;
        int bsize = -1;
        for (size_t i = 0; i + 4 <= extra.size();) {
            uint8_t si1 = extra[i], si2 = extra[i + 1];
            uint16_t slen = static_cast<uint16_t>(extra[i + 2] | (extra[i + 3] << 8));
            if (si1 == 66 && si2 == 67 && slen == 2 && i + 6 <= extra.size()) {
                bsize = extra[i + 4] | (extra[i + 5] << 8);
            }
            i += 4 + slen;
        }
        if (bsize < 0) return -1;
        // total member size = bsize + 1; payload = rest minus 8-byte trailer
        long long remaining = static_cast<long long>(bsize) + 1 - 12 - xlen;
        if (remaining < 8) return -1;
        size_t payload_size = static_cast<size_t>(remaining - 8);
        payload.resize(payload_size);
        if (payload_size > 0 &&
            fread(payload.data(), 1, payload_size, file) != payload_size) {
            return -1;
        }
        uint8_t trailer[8];
        if (fread(trailer, 1, 8, file) != 8) return -1;
        *crc = static_cast<uint32_t>(trailer[0]) | (trailer[1] << 8) |
               (trailer[2] << 16) | (static_cast<uint32_t>(trailer[3]) << 24);
        *isize = static_cast<uint32_t>(trailer[4]) | (trailer[5] << 8) |
                 (trailer[6] << 16) | (static_cast<uint32_t>(trailer[7]) << 24);
        if (*isize > (1u << 16)) return -1;  // BGZF blocks are <= 64KB raw
        return 1;
    }

    void io_loop() {
        for (;;) {
            std::vector<uint8_t> payload;
            uint32_t crc = 0, isize = 0;
            int status = read_block(payload, &crc, &isize);
            if (status < 0) {
                fail("malformed BGZF block");
                return;
            }
            if (status == 0) {
                std::lock_guard<std::mutex> lock(mu);
                io_done = true;
                cv_ready.notify_all();
                cv_work.notify_all();
                return;
            }
            std::unique_lock<std::mutex> lock(mu);
            cv_free.wait(lock, [&] {
                return shutdown || produced - consumed < DEPTH;
            });
            if (shutdown) return;
            Slot& slot = slots[produced % DEPTH];
            slot.payload = std::move(payload);
            slot.crc = crc;
            slot.isize = isize;
            slot.state = 1;
            ++produced;
            lock.unlock();
            cv_work.notify_one();
        }
    }

    void worker_loop() {
        z_stream zs;
        std::memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, -15) != Z_OK) {
            fail("inflateInit2 failed");
            return;
        }
        for (;;) {
            int index = -1;
            {
                std::unique_lock<std::mutex> lock(mu);
                cv_work.wait(lock, [&] {
                    if (shutdown) return true;
                    for (long long s = consumed; s < produced; ++s) {
                        if (slots[s % DEPTH].state == 1) return true;
                    }
                    return io_done;
                });
                if (shutdown) break;
                for (long long s = consumed; s < produced; ++s) {
                    if (slots[s % DEPTH].state == 1) {
                        index = static_cast<int>(s % DEPTH);
                        slots[index].state = 2;
                        break;
                    }
                }
                if (index < 0) {
                    if (io_done) break;
                    continue;
                }
            }
            Slot& slot = slots[index];
            slot.raw.resize(slot.isize);
            inflateReset(&zs);
            zs.next_in = slot.payload.data();
            zs.avail_in = static_cast<uInt>(slot.payload.size());
            // zlib rejects next_out == NULL even with avail_out == 0
            // (empty EOF-marker blocks) — give it a scratch byte
            uint8_t scratch = 0;
            zs.next_out = slot.isize > 0 ? slot.raw.data() : &scratch;
            zs.avail_out = slot.isize > 0
                ? static_cast<uInt>(slot.raw.size()) : 1;
            int status = inflate(&zs, Z_FINISH);
            bool ok = status == Z_STREAM_END &&
                      zs.total_out == slot.isize;
            if (ok && slot.isize > 0) {
                uint32_t crc = static_cast<uint32_t>(
                    crc32(0, slot.raw.data(), static_cast<uInt>(slot.raw.size())));
                ok = crc == slot.crc;
            }
            if (!ok) {
                fail("BGZF block inflate/CRC failure");
                break;
            }
            {
                std::lock_guard<std::mutex> lock(mu);
                slot.state = 3;
            }
            cv_ready.notify_all();
        }
        inflateEnd(&zs);
    }

    // Consumer: copy up to `want` decompressed bytes in stream order.
    // Returns bytes copied (0 at EOF), or -1 on error.
    int64_t read(uint8_t* out, int64_t want) {
        int64_t got = 0;
        while (got < want) {
            std::unique_lock<std::mutex> lock(mu);
            cv_ready.wait(lock, [&] {
                if (shutdown || !error.empty()) return true;
                if (consumed < produced &&
                    slots[consumed % DEPTH].state == 3)
                    return true;
                return io_done && consumed >= produced;
            });
            if (!error.empty()) return -1;
            if (shutdown) return -1;
            if (consumed >= produced && io_done) break;  // EOF
            Slot& slot = slots[consumed % DEPTH];
            if (slot.state != 3) continue;
            size_t available = slot.raw.size() - raw_pos;
            size_t take = static_cast<size_t>(
                std::min<int64_t>(want - got, static_cast<int64_t>(available)));
            std::memcpy(out + got, slot.raw.data() + raw_pos, take);
            raw_pos += take;
            got += static_cast<int64_t>(take);
            if (raw_pos >= slot.raw.size()) {
                slot.state = 0;
                slot.payload.clear();
                raw_pos = 0;
                ++consumed;
                lock.unlock();
                cv_free.notify_one();
            }
        }
        return got;
    }
};

static int64_t bgzf_read_helper(BgzfReader* reader, uint8_t* out, int64_t want) {
    return reader->read(out, want);
}

static const char* bgzf_error_helper(BgzfReader* reader) {
    return reader->error.c_str();
}

// Open helper shared by the C ABI and the FASTQ reader: nullptr when the
// file is missing or not BGZF-framed.
static BgzfReader* bgzf_open_internal(const char* path, int threads) {
    FILE* file = fopen(path, "rb");
    if (file == nullptr) return nullptr;
    uint8_t header[18];
    size_t got = fread(header, 1, 18, file);
    bool bgzf = got == 18 && header[0] == 0x1F && header[1] == 0x8B &&
                header[2] == 8 && (header[3] & 4) != 0 &&
                header[12] == 66 && header[13] == 67;
    if (!bgzf) {
        fclose(file);
        return nullptr;
    }
    rewind(file);
    BgzfReader* reader = new BgzfReader();
    reader->file = file;
    if (threads < 1) threads = 1;
    if (threads > 16) threads = 16;
    reader->io_thread = std::thread([reader] { reader->io_loop(); });
    for (int i = 0; i < threads; ++i) {
        reader->workers.emplace_back([reader] { reader->worker_loop(); });
    }
    return reader;
}

}  // namespace

template <int W>
static void apply_token_fixed(
    int32_t n,
    const uint8_t* src_code, const uint8_t* src_qual,
    int64_t src_row_stride, int64_t start,
    const int32_t* size,
    uint8_t* dst_code, uint8_t* dst_qual,
    int64_t dst_row_stride, int64_t dst_col_offset,
    int32_t* dst_len
) {
    // constant-size memcpy inlines to straight-line loads/stores
    for (int32_t r = 0; r < n; ++r) {
        const int64_t src_off = static_cast<int64_t>(r) * src_row_stride + start;
        const int64_t dst_off =
            static_cast<int64_t>(r) * dst_row_stride + dst_col_offset;
        const int32_t s = size[r];
        if (s == W) {
            std::memcpy(dst_code + dst_off, src_code + src_off, W);
            std::memcpy(dst_qual + dst_off, src_qual + src_off, W);
        } else {
            const int32_t c = s > W ? W : (s > 0 ? s : 0);
            std::memcpy(dst_code + dst_off, src_code + src_off, c);
            std::memcpy(dst_qual + dst_off, src_qual + src_off, c);
            std::memset(dst_code + dst_off + c, 0, W - c);
            std::memset(dst_qual + dst_off + c, 0, W - c);
        }
        dst_len[r] += s;
    }
}

extern "C" {

// Open `path` as a parallel BGZF stream with `threads` inflate workers.
// Returns nullptr when the file is missing OR not BGZF-framed (the caller
// falls back to its serial gzip path).
void* pq_bgzf_open(const char* path, int threads) {
    return bgzf_open_internal(path, threads);
}

int64_t pq_bgzf_read(void* handle, uint8_t* out, int64_t want) {
    return static_cast<BgzfReader*>(handle)->read(out, want);
}

const char* pq_bgzf_error(void* handle) {
    return static_cast<BgzfReader*>(handle)->error.c_str();
}

void pq_bgzf_close(void* handle) {
    delete static_cast<BgzfReader*>(handle);
}

// --- native BAM batch reader -----------------------------------------------
// The reference's own docs recommend BAM input for throughput
// (docs/configuration.md:20): with the parallel BGZF pool above plus this
// record parser, BAM ingests straight into the SoA batch buffers without
// a per-record Python loop. BAM seq nibbles ARE the 4-bit codes the whole
// framework uses, so decoding is an unpack, not a translation.

struct BamBatchReader {
    BgzfReader* bgzf = nullptr;
    std::string error;
    bool eof = false;
    // record at `position` exceeded the caller's matrices (grow
    // protocol): position is NOT advanced, the next read_batch call
    // re-parses it in place against the regrown matrices
    int32_t pending_l_seq = 0;
    // local decompressed buffer: per-record reads would otherwise take
    // the BGZF ring mutex twice per record
    std::vector<uint8_t> buffer;
    size_t position = 0;
    bool stream_eof = false;

    ~BamBatchReader() { delete bgzf; }

    bool refill(size_t need) {
        if (position > 0) {
            buffer.erase(buffer.begin(), buffer.begin() + position);
            position = 0;
        }
        while (buffer.size() < need && !stream_eof) {
            size_t old = buffer.size();
            size_t chunk = std::max<size_t>(need, 1 << 20);
            buffer.resize(old + chunk);
            int64_t got = bgzf->read(buffer.data() + old,
                                     static_cast<int64_t>(chunk));
            if (got < 0) {
                error = bgzf->error.empty() ? "BGZF read failed"
                                            : bgzf->error;
                buffer.resize(old);
                return false;
            }
            buffer.resize(old + static_cast<size_t>(got));
            if (static_cast<size_t>(got) < chunk) stream_eof = true;
        }
        return buffer.size() >= need;
    }

    bool read_exact(uint8_t* out, size_t n) {
        if (buffer.size() - position < n && !refill(n)) {
            if (error.empty()) {
                if (buffer.size() > position) error = "truncated BAM stream";
                eof = true;
            }
            return false;
        }
        std::memcpy(out, buffer.data() + position, n);
        position += n;
        return true;
    }
};

void* pq_bam_open(const char* path, int threads) {
    BgzfReader* bgzf = bgzf_open_internal(path, threads);
    if (bgzf == nullptr) return nullptr;  // not BGZF: caller falls back
    BamBatchReader* reader = new BamBatchReader();
    reader->bgzf = bgzf;
    uint8_t magic[4];
    if (!reader->read_exact(magic, 4) || std::memcmp(magic, "BAM\x01", 4) != 0) {
        delete reader;
        return nullptr;
    }
    uint8_t quad[4];
    if (!reader->read_exact(quad, 4)) { delete reader; return nullptr; }
    int32_t l_text;
    std::memcpy(&l_text, quad, 4);
    std::vector<uint8_t> skip(l_text > 0 ? l_text : 0);
    if (l_text > 0 && !reader->read_exact(skip.data(), skip.size())) {
        delete reader; return nullptr;
    }
    if (!reader->read_exact(quad, 4)) { delete reader; return nullptr; }
    int32_t n_ref;
    std::memcpy(&n_ref, quad, 4);
    for (int32_t i = 0; i < n_ref; ++i) {
        if (!reader->read_exact(quad, 4)) { delete reader; return nullptr; }
        int32_t l_name;
        std::memcpy(&l_name, quad, 4);
        std::vector<uint8_t> ref(l_name + 4);
        if (!reader->read_exact(ref.data(), ref.size())) {
            delete reader; return nullptr;
        }
    }
    return reader;
}

const char* pq_bam_error(void* handle) {
    return static_cast<BamBatchReader*>(handle)->error.c_str();
}

int64_t pq_bam_pending_length(void* handle) {
    return static_cast<BamBatchReader*>(handle)->pending_l_seq;
}

void pq_bam_close(void* handle) {
    delete static_cast<BamBatchReader*>(handle);
}

// 256-entry LUT: one packed seq byte -> its two 4-bit codes, written as
// one 16-bit store (hi nibble first, matching BAM base order)
struct BamNibbleLut {
    uint16_t lut[256];
    BamNibbleLut() {
        for (int b = 0; b < 256; ++b) {
            uint8_t pair[2] = { static_cast<uint8_t>(b >> 4),
                                static_cast<uint8_t>(b & 0xF) };
            std::memcpy(&lut[b], pair, 2);
        }
    }
};

static const uint16_t* bam_nibble_lut() {
    // magic-static init: thread-safe when BAM feeds parse concurrently
    // (io/ingest.py uses a thread pool for 2+ input URLs)
    static const BamNibbleLut table;
    return table.lut;
}

// Emit one raw record body (parsed IN PLACE from the decompressed
// buffer) into the batch row; returns false if it does not fit
// max_length (caller leaves it unconsumed and regrows).
static bool bam_emit_record(
    const uint8_t* body, size_t body_size, int32_t row, int32_t max_length,
    uint8_t* code, uint8_t* qual, int32_t* length, uint8_t* qcfail,
    char* names, int64_t* names_used, int64_t* name_offset,
    std::string* error
) {
    if (body_size < 32) { *error = "truncated BAM record"; return true; }
    uint8_t l_read_name = body[8];
    uint16_t n_cigar;
    std::memcpy(&n_cigar, body + 12, 2);
    uint16_t flag;
    std::memcpy(&flag, body + 14, 2);
    int32_t l_seq;
    std::memcpy(&l_seq, body + 16, 4);
    if (l_seq < 0 || l_read_name == 0) {
        *error = "malformed BAM record header";
        return true;
    }
    size_t name_at = 32;
    size_t cigar_at = name_at + l_read_name;
    size_t seq_at = cigar_at + 4ull * n_cigar;
    size_t qual_at = seq_at + (static_cast<size_t>(l_seq) + 1) / 2;
    if (qual_at + static_cast<size_t>(l_seq) > body_size) {
        *error = "truncated BAM record body";
        return true;
    }
    if (l_seq > max_length) return false;  // caller grows

    uint8_t* code_row = code + static_cast<int64_t>(row) * max_length;
    uint8_t* qual_row = qual + static_cast<int64_t>(row) * max_length;
    const uint8_t* nibbles = body + seq_at;
    const uint16_t* lut = bam_nibble_lut();
    int32_t pairs = l_seq >> 1;
    for (int32_t i = 0; i < pairs; ++i) {
        std::memcpy(code_row + 2 * i, &lut[nibbles[i]], 2);
    }
    if (l_seq & 1) code_row[l_seq - 1] = nibbles[pairs] >> 4;
    const uint8_t* quals = body + qual_at;
    for (int32_t i = 0; i < l_seq; ++i) {
        // classification quality domain is [0, 0x80): 0xFF is the BAM
        // missing-quality sentinel (-> 0), anything else above the
        // domain is spec-invalid and clamps — the f64 LUTs (Python and
        // the classifier below) are sized 0x80, so an unclamped byte
        // would read out of bounds
        uint8_t q = quals[i];
        qual_row[i] = q == 0xFF ? 0 : (q & 0x80 ? 0x7F : q);
    }
    size_t name_length = l_read_name > 0 ? l_read_name - 1 : 0;  // drop NUL
    if (name_length > 4000) name_length = 4000;
    std::memcpy(names + *names_used, body + name_at, name_length);
    *names_used += static_cast<int64_t>(name_length);
    length[row] = l_seq;
    qcfail[row] = (flag & 0x200) ? 1 : 0;
    name_offset[row + 1] = *names_used;
    return true;
}

// Same contract as pq_fastq_read_batch: count; 0 EOF; -1 malformed;
// -2 names arena exhausted; -3 record exceeds max_length (stashed).
int32_t pq_bam_read_batch(
    void* handle,
    int32_t max_records,
    int32_t max_length,
    uint8_t* code,
    uint8_t* qual,
    int32_t* length,
    uint8_t* qcfail,
    char* names,
    int64_t names_capacity,
    int64_t* name_offset
) {
    BamBatchReader* reader = static_cast<BamBatchReader*>(handle);
    int32_t count = 0;
    int64_t names_used = 0;
    name_offset[0] = 0;
    reader->pending_l_seq = 0;
    while (count < max_records) {
        if (names_capacity - names_used < 4096) {
            return count > 0 ? count : -2;
        }
        // peek the record size, then parse the body IN PLACE from the
        // decompressed buffer (no per-record copy)
        if (reader->buffer.size() - reader->position < 4 &&
            !reader->refill(4)) {
            if (!reader->error.empty()) return -1;
            if (reader->buffer.size() > reader->position) {
                reader->error = "truncated BAM stream";
                return -1;
            }
            break;  // clean EOF
        }
        int32_t block_size;
        std::memcpy(&block_size, reader->buffer.data() + reader->position, 4);
        if (block_size < 32 || block_size > (1 << 28)) {
            reader->error = "implausible BAM record size";
            return -1;
        }
        size_t need = 4ull + static_cast<size_t>(block_size);
        if (reader->buffer.size() - reader->position < need &&
            !reader->refill(need)) {
            if (reader->error.empty()) reader->error = "truncated BAM record";
            return -1;
        }
        const uint8_t* body = reader->buffer.data() + reader->position + 4;
        if (!bam_emit_record(body, block_size, count, max_length, code,
                             qual, length, qcfail, names, &names_used,
                             name_offset, &reader->error)) {
            // record does not fit: leave it unconsumed for the regrown call
            std::memcpy(&reader->pending_l_seq, body + 16, 4);
            return count > 0 ? count : -3;
        }
        if (!reader->error.empty()) return -1;
        reader->position += need;
        ++count;
    }
    return count;
}

void* pq_fastq_open(const char* path, int phred_offset) {
    Reader* reader = new Reader();
    reader->phred_offset = phred_offset;
    // BGZF-framed input (BAM-style gzip, htslib-written .gz) decompresses
    // on the parallel block pool; plain/other gzip falls back to zlib
    const char* env = getenv("PHENIQS_BGZF_THREADS");
    int threads = env != nullptr ? atoi(env) : 3;
    reader->bgzf = bgzf_open_internal(path, threads);
    if (reader->bgzf == nullptr) {
        reader->file = gzopen(path, "rb");
        if (reader->file == nullptr) {
            delete reader;
            return nullptr;
        }
        gzbuffer(reader->file, 1 << 20);
    }
    return reader;
}

const char* pq_fastq_error(void* handle) {
    if (handle == nullptr) return "invalid handle";
    return static_cast<Reader*>(handle)->error.c_str();
}

void pq_fastq_close(void* handle) {
    if (handle == nullptr) return;
    Reader* reader = static_cast<Reader*>(handle);
    if (reader->file != nullptr) gzclose(reader->file);
    delete reader->bgzf;
    delete reader;
}

// Parse up to `max_records` records.
//   code, qual        : (max_records, max_length) row-major uint8
//   length            : (max_records,) int32 — sequence lengths (clipped to
//                       max_length when longer; full length reported)
//   qcfail            : (max_records,) uint8 — Illumina comment filter flag
//   names             : byte arena receiving concatenated read names
//   name_offset       : (max_records + 1,) int64 prefix offsets into names
// Length (bytes) of a record stashed because it exceeded max_length, or 0.
int64_t pq_fastq_pending_length(void* handle) {
    Reader* reader = static_cast<Reader*>(handle);
    return reader->has_pending
        ? static_cast<int64_t>(reader->pending_sequence.size()) : 0;
}

// Returns number parsed; 0 at EOF; -1 on malformed input (see
// pq_fastq_error); -2 when the names arena is exhausted; -3 when a record
// exceeds max_length (stashed — query pq_fastq_pending_length, grow the
// matrices, and call again; never silently truncates sequence data).
int32_t pq_fastq_read_batch(
    void* handle,
    int32_t max_records,
    int32_t max_length,
    uint8_t* code,
    uint8_t* qual,
    int32_t* length,
    uint8_t* qcfail,
    char* names,
    int64_t names_capacity,
    int64_t* name_offset
) {
    Reader* reader = static_cast<Reader*>(handle);
    int32_t count = 0;
    int64_t names_used = 0;
    name_offset[0] = 0;
    const int offset = reader->phred_offset;

    while (count < max_records) {
        // reserve generous headroom so the name copy below cannot overflow
        if (names_capacity - names_used < 4096) {
            return count > 0 ? count : -2;
        }
        if (reader->has_pending) {
            // a record stashed by a previous call because it was longer than
            // that call's max_length; emit it now if it fits, else tell the
            // caller to grow
            size_t plen = reader->pending_sequence.size();
            if (plen > static_cast<size_t>(max_length)) {
                return count > 0 ? count : -3;
            }
            uint8_t* code_row = code + static_cast<int64_t>(count) * max_length;
            uint8_t* qual_row = qual + static_cast<int64_t>(count) * max_length;
            for (size_t i = 0; i < plen; ++i) {
                code_row[i] = kAsciiToBam.table[static_cast<unsigned char>(
                    reader->pending_sequence[i])];
                int q = static_cast<unsigned char>(reader->pending_quality[i]) - offset;
                // classification quality domain is [0, 0x80): clamp both
                // sides (binary garbage in a quality line would otherwise
                // index the 0x80-sized substitution LUT out of bounds)
                qual_row[i] = static_cast<uint8_t>(q < 0 ? 0 : (q > 0x7F ? 0x7F : q));
            }
            size_t name_length = std::min<size_t>(reader->pending_name.size(), 4000);
            std::memcpy(names + names_used, reader->pending_name.data(), name_length);
            length[count] = static_cast<int32_t>(plen);
            qcfail[count] = reader->pending_fail;
            names_used += static_cast<int64_t>(name_length);
            name_offset[count + 1] = names_used;
            ++count;
            reader->has_pending = false;
            reader->pending_name.clear();
            reader->pending_sequence.clear();
            reader->pending_quality.clear();
            continue;
        }
        const char* header;
        size_t header_length;
        if (!reader->line(&header, &header_length)) break;  // EOF
        if (header_length == 0) continue;                   // skip blank lines
        if (header[0] != '@') {
            reader->error = "corrupt FASTQ header: ";
            reader->error.append(header, std::min<size_t>(header_length, 64));
            return -1;
        }
        size_t name_end = 1;
        while (name_end < header_length && header[name_end] != ' ') ++name_end;
        size_t name_length = std::min<size_t>(name_end - 1, 4000);
        // copy the name into the arena NOW — later line() calls may
        // invalidate the header span
        std::memcpy(names + names_used, header + 1, name_length);
        // Illumina comment: "<segment>:<filter Y/N>:<control>:<barcode>"
        uint8_t fail = 0;
        if (name_end < header_length) {
            const char* comment = header + name_end + 1;
            size_t comment_length = header_length - name_end - 1;
            size_t first_colon = 0;
            while (first_colon < comment_length && comment[first_colon] != ':')
                ++first_colon;
            if (first_colon + 1 < comment_length) {
                size_t second_colon = first_colon + 1;
                while (second_colon < comment_length && comment[second_colon] != ':')
                    ++second_colon;
                if (second_colon - first_colon == 2 &&
                    comment[first_colon + 1] == 'Y') {
                    fail = 1;
                }
            }
        }

        const char* sequence;
        size_t sequence_length;
        if (!reader->line(&sequence, &sequence_length)) {
            reader->error = "truncated FASTQ record (missing sequence)";
            return -1;
        }
        if (sequence_length > static_cast<size_t>(max_length)) {
            // longer than the batch matrices: stash the full record (copy
            // now — later line() calls invalidate the spans) and hand the
            // batch back; the caller grows max_length and retries
            reader->pending_sequence.assign(sequence, sequence_length);
            const char* separator;
            size_t separator_length;
            if (!reader->line(&separator, &separator_length) ||
                separator_length == 0 || separator[0] != '+') {
                reader->error = "corrupt FASTQ separator";
                return -1;
            }
            const char* quality;
            size_t quality_length;
            if (!reader->line(&quality, &quality_length)) {
                reader->error = "truncated FASTQ record (missing quality)";
                return -1;
            }
            if (quality_length != sequence_length) {
                reader->error = "sequence/quality length mismatch for ";
                reader->error.append(names + names_used, name_length);
                return -1;
            }
            reader->pending_quality.assign(quality, quality_length);
            reader->pending_name.assign(names + names_used, name_length);
            reader->pending_fail = fail;
            reader->has_pending = true;
            return count > 0 ? count : -3;
        }
        // encode the sequence into its row immediately, before the span can
        // be invalidated. Rows are NOT padded here: zero-filling every row
        // to the full matrix stride cost ~GBs of memset per million reads;
        // the Python caller zeroes only the (rare) short rows up to the
        // batch width.
        uint8_t* code_row = code + static_cast<int64_t>(count) * max_length;
        uint8_t* qual_row = qual + static_cast<int64_t>(count) * max_length;
        size_t keep = sequence_length;
        for (size_t i = 0; i < keep; ++i) {
            code_row[i] = kAsciiToBam.table[
                static_cast<unsigned char>(sequence[i])];
        }

        const char* separator;
        size_t separator_length;
        if (!reader->line(&separator, &separator_length) ||
            separator_length == 0 || separator[0] != '+') {
            reader->error = "corrupt FASTQ separator";
            return -1;
        }

        const char* quality;
        size_t quality_length;
        if (!reader->line(&quality, &quality_length)) {
            reader->error = "truncated FASTQ record (missing quality)";
            return -1;
        }
        if (quality_length != sequence_length) {
            reader->error = "sequence/quality length mismatch for ";
            reader->error.append(names + names_used, name_length);
            return -1;
        }
        for (size_t i = 0; i < keep; ++i) {
            int q = static_cast<unsigned char>(quality[i]) - offset;
            // same two-sided clamp as the pending-quality path above
            qual_row[i] = static_cast<uint8_t>(q < 0 ? 0 : (q > 0x7F ? 0x7F : q));
        }

        length[count] = static_cast<int32_t>(sequence_length);
        qcfail[count] = fail;
        names_used += static_cast<int64_t>(name_length);
        name_offset[count + 1] = names_used;
        ++count;
    }
    return count;
}

// BAM nibble -> IUPAC ASCII (mirrors pheniqs_tpu.iupac.BAM_TO_ASCII)
static const char kBamToAscii[17] = "=ACMGRSVTWYHKDBN";

// Per-line SAM prefix "\t<flag>\t*\t0\t0\t*\t*\t0\t0\t": the flag takes a
// handful of distinct values per batch (segment flag | optional QCFAIL),
// so cache the rendered prefix instead of sprintf-ing every line.
struct FlagPrefixCache {
    int32_t flag = -1;
    int len = 0;
    char text[48];
    inline char* emit(char* cursor, int32_t value) {
        if (value != flag) {
            flag = value;
            len = std::sprintf(text, "\t%d\t*\t0\t0\t*\t*\t0\t0\t", value);
        }
        std::memcpy(cursor, text, static_cast<size_t>(len));
        return cursor + len;
    }
};

// printf "%g" via std::to_chars(general, 6): byte-identical on doubles
// (verified exhaustively over 20M float32-derived samples in (0,1), the
// confidence-tag domain) and ~2x faster than sprintf.
static inline char* emit_g(char* cursor, double value) {
    auto result = std::to_chars(
        cursor, cursor + 40, value, std::chars_format::general, 6);
    return result.ptr;
}

// Format a batch of SAM alignment lines into `out`.
//   names / name_offset : NUL-free name arena with (n+1) prefix offsets
//   flag                : per-record SAM flags
//   code, qual          : (n, width) row-major BAM codes / phred values
//   length              : per-record sequence lengths
//   tags / tag_offset   : per-record pre-rendered aux suffix (may be empty)
//   line_offset         : (n+1) output prefix offsets
// Returns bytes written, or -(bytes required) when out_capacity is too
// small (caller grows and retries).
int64_t pq_sam_format_batch(
    int32_t n,
    const char* names,
    const int64_t* name_offset,
    const int32_t* flag,
    const uint8_t* code,
    const uint8_t* qual,
    const int32_t* length,
    int32_t width,
    int32_t phred_offset,
    const char* tags,
    const int64_t* tag_offset,
    char* out,
    int64_t out_capacity,
    int64_t* line_offset
) {
    // worst-case size estimate
    int64_t required = 0;
    for (int32_t r = 0; r < n; ++r) {
        int64_t name_length = name_offset[r + 1] - name_offset[r];
        int64_t tag_length = tag_offset[r + 1] - tag_offset[r];
        int64_t l = length[r] > 0 ? length[r] : 1;
        required += name_length + 32 + 2 * l + tag_length + 2;
    }
    if (required > out_capacity) return -required;

    char* cursor = out;
    line_offset[0] = 0;
    FlagPrefixCache flag_prefix;
    for (int32_t r = 0; r < n; ++r) {
        int64_t name_length = name_offset[r + 1] - name_offset[r];
        std::memcpy(cursor, names + name_offset[r], name_length);
        cursor += name_length;
        cursor = flag_prefix.emit(cursor, flag[r]);
        int32_t l = length[r] > width ? width : length[r];  // defense in depth
        const uint8_t* code_row = code + static_cast<int64_t>(r) * width;
        const uint8_t* qual_row = qual + static_cast<int64_t>(r) * width;
        if (l <= 0) {
            *cursor++ = '*';
            *cursor++ = '\t';
            *cursor++ = '*';
        } else {
            for (int32_t i = 0; i < l; ++i) {
                cursor[i] = kBamToAscii[code_row[i] & 0xF];
            }
            cursor += l;
            *cursor++ = '\t';
            for (int32_t i = 0; i < l; ++i) {
                cursor[i] = static_cast<char>(qual_row[i] + phred_offset);
            }
            cursor += l;
        }
        int64_t tag_length = tag_offset[r + 1] - tag_offset[r];
        if (tag_length > 0) {
            *cursor++ = '\t';
            std::memcpy(cursor, tags + tag_offset[r], tag_length);
            cursor += tag_length;
        }
        *cursor++ = '\n';
        line_offset[r + 1] = cursor - out;
    }
    return cursor - out;
}

// Format a batch of SAM lines with tag columns rendered natively.
//
// Column kinds:
//   0 SPAN  — per-read byte span: buffers[k] + starts[k][r] + lens[k][r];
//             emitted as "\t<prefix><bytes>" when lens[k][r] > 0
//   1 FLOAT — floats[k][r] printed with %g (float32 semantics, like
//             htslib) when masks[k][r] != 0
//   2 CONST — buffers[k] (prefix_len bytes in prefixes[k]) emitted for
//             every read; used for per-segment FI/TC tags
int64_t pq_sam_format_full(
    int32_t n,
    const char* names,
    const int64_t* name_offset,
    const int32_t* flag,
    const uint8_t* code,
    const uint8_t* qual,
    const int32_t* length,
    int32_t width,
    int32_t phred_offset,
    int32_t n_columns,
    const uint8_t* kinds,
    const char* const* prefixes,
    const int32_t* prefix_lens,
    const char* const* buffers,
    const int64_t* const* starts,
    const int32_t* const* lens,
    const float* const* floats,
    const uint8_t* const* masks,
    char* out,
    int64_t out_capacity,
    int64_t* line_offset
) {
    // worst-case estimate
    int64_t required = 0;
    for (int32_t r = 0; r < n; ++r) {
        int64_t l = length[r] > 0 ? length[r] : 1;
        required += (name_offset[r + 1] - name_offset[r]) + 34 + 2 * l;
    }
    for (int32_t k = 0; k < n_columns; ++k) {
        if (kinds[k] == 0) {
            for (int32_t r = 0; r < n; ++r) {
                if (lens[k][r] > 0) {
                    required += 1 + prefix_lens[k] + lens[k][r];
                }
            }
        } else if (kinds[k] == 1) {
            required += static_cast<int64_t>(n) * (1 + prefix_lens[k] + 16);
        } else {
            required += static_cast<int64_t>(n) * (1 + prefix_lens[k]);
        }
    }
    if (required > out_capacity) return -required;

    char* cursor = out;
    line_offset[0] = 0;
    FlagPrefixCache flag_prefix;
    for (int32_t r = 0; r < n; ++r) {
        int64_t name_length = name_offset[r + 1] - name_offset[r];
        std::memcpy(cursor, names + name_offset[r], name_length);
        cursor += name_length;
        cursor = flag_prefix.emit(cursor, flag[r]);
        int32_t l = length[r] > width ? width : length[r];  // defense in depth
        const uint8_t* code_row = code + static_cast<int64_t>(r) * width;
        const uint8_t* qual_row = qual + static_cast<int64_t>(r) * width;
        if (l <= 0) {
            *cursor++ = '*';
            *cursor++ = '\t';
            *cursor++ = '*';
        } else {
            for (int32_t i = 0; i < l; ++i) {
                cursor[i] = kBamToAscii[code_row[i] & 0xF];
            }
            cursor += l;
            *cursor++ = '\t';
            for (int32_t i = 0; i < l; ++i) {
                cursor[i] = static_cast<char>(qual_row[i] + phred_offset);
            }
            cursor += l;
        }
        for (int32_t k = 0; k < n_columns; ++k) {
            switch (kinds[k]) {
                case 0: {
                    int32_t span = lens[k][r];
                    if (span > 0) {
                        *cursor++ = '\t';
                        std::memcpy(cursor, prefixes[k], prefix_lens[k]);
                        cursor += prefix_lens[k];
                        std::memcpy(cursor, buffers[k] + starts[k][r], span);
                        cursor += span;
                    }
                    break;
                }
                case 1: {
                    if (masks[k][r]) {
                        *cursor++ = '\t';
                        std::memcpy(cursor, prefixes[k], prefix_lens[k]);
                        cursor += prefix_lens[k];
                        cursor = emit_g(
                            cursor, static_cast<double>(floats[k][r]));
                    }
                    break;
                }
                default: {
                    *cursor++ = '\t';
                    std::memcpy(cursor, prefixes[k], prefix_lens[k]);
                    cursor += prefix_lens[k];
                    break;
                }
            }
        }
        *cursor++ = '\n';
        line_offset[r + 1] = cursor - out;
    }
    return cursor - out;
}

// Format a batch of BAM records (the uncompressed record stream, each
// prefixed with its block_size) from the same tag-column material as
// pq_sam_format_full: span columns become Z tags (tag chars = first two
// prefix bytes, value NUL-terminated), float columns become 'f' tags
// (raw little-endian float32), const columns are pre-encoded binary aux
// bytes copied verbatim (per-segment FI/TC). Demultiplexed reads are
// unaligned by definition (reference read.h:28-139), so the placement
// fields are the unmapped constants — matching BamWriter.write_record
// byte for byte so the columnar and per-record paths are
// interchangeable. Returns bytes written, or -(bytes required).
int64_t pq_bam_format_full(
    int32_t n,
    const char* names,
    const int64_t* name_offset,
    const int32_t* flag,
    const uint8_t* code,
    const uint8_t* qual,
    const int32_t* length,
    int32_t width,
    int32_t phred_offset,  // unused (BAM stores raw phred); kept for ABI symmetry
    int32_t n_columns,
    const uint8_t* kinds,
    const char* const* prefixes,
    const int32_t* prefix_lens,
    const char* const* buffers,
    const int64_t* const* starts,
    const int32_t* const* lens,
    const float* const* floats,
    const uint8_t* const* masks,
    char* out,
    int64_t out_capacity,
    int64_t* record_offset
) {
    (void)phred_offset;
    int64_t required = 0;
    for (int32_t r = 0; r < n; ++r) {
        int32_t l = length[r] > width ? width : length[r];
        if (l < 0) l = 0;
        required += 36 + (name_offset[r + 1] - name_offset[r]) + 1
                  + (l + 1) / 2 + l;
    }
    for (int32_t k = 0; k < n_columns; ++k) {
        if (kinds[k] == 0) {
            for (int32_t r = 0; r < n; ++r) {
                if (lens[k][r] > 0) required += 4 + lens[k][r];
            }
        } else if (kinds[k] == 1) {
            required += static_cast<int64_t>(n) * 7;
        } else {
            required += static_cast<int64_t>(n) * prefix_lens[k];
        }
    }
    if (required > out_capacity) return -required;

    char* cursor = out;
    record_offset[0] = 0;
    const uint16_t unmapped_bin = 4680;
    for (int32_t r = 0; r < n; ++r) {
        char* block_start = cursor;
        cursor += 4;  // block_size, backfilled below
        int32_t minus_one = -1;
        std::memcpy(cursor, &minus_one, 4); cursor += 4;  // refID
        std::memcpy(cursor, &minus_one, 4); cursor += 4;  // pos
        int64_t name_length = name_offset[r + 1] - name_offset[r];
        *cursor++ = static_cast<char>(name_length + 1);   // l_read_name
        *cursor++ = 0;                                    // mapq
        std::memcpy(cursor, &unmapped_bin, 2); cursor += 2;
        uint16_t n_cigar = 0;
        std::memcpy(cursor, &n_cigar, 2); cursor += 2;
        uint16_t flag16 = static_cast<uint16_t>(flag[r]);
        std::memcpy(cursor, &flag16, 2); cursor += 2;
        int32_t l = length[r] > width ? width : length[r];
        if (l < 0) l = 0;
        std::memcpy(cursor, &l, 4); cursor += 4;          // l_seq
        std::memcpy(cursor, &minus_one, 4); cursor += 4;  // next_refID
        std::memcpy(cursor, &minus_one, 4); cursor += 4;  // next_pos
        int32_t zero = 0;
        std::memcpy(cursor, &zero, 4); cursor += 4;       // tlen
        std::memcpy(cursor, names + name_offset[r], name_length);
        cursor += name_length;
        *cursor++ = 0;
        const uint8_t* code_row = code + static_cast<int64_t>(r) * width;
        const uint8_t* qual_row = qual + static_cast<int64_t>(r) * width;
        for (int32_t i = 0; i + 1 < l; i += 2) {
            *cursor++ = static_cast<char>(
                ((code_row[i] & 0xF) << 4) | (code_row[i + 1] & 0xF));
        }
        if (l & 1) {
            *cursor++ = static_cast<char>((code_row[l - 1] & 0xF) << 4);
        }
        std::memcpy(cursor, qual_row, l);
        cursor += l;
        for (int32_t k = 0; k < n_columns; ++k) {
            switch (kinds[k]) {
                case 0: {
                    int32_t span = lens[k][r];
                    if (span > 0) {
                        *cursor++ = prefixes[k][0];
                        *cursor++ = prefixes[k][1];
                        *cursor++ = 'Z';
                        std::memcpy(cursor, buffers[k] + starts[k][r], span);
                        cursor += span;
                        *cursor++ = 0;
                    }
                    break;
                }
                case 1: {
                    if (masks[k][r]) {
                        *cursor++ = prefixes[k][0];
                        *cursor++ = prefixes[k][1];
                        *cursor++ = 'f';
                        float value = floats[k][r];
                        std::memcpy(cursor, &value, 4);
                        cursor += 4;
                    }
                    break;
                }
                default: {
                    std::memcpy(cursor, prefixes[k], prefix_lens[k]);
                    cursor += prefix_lens[k];
                    break;
                }
            }
        }
        int32_t block_size = static_cast<int32_t>(cursor - block_start - 4);
        std::memcpy(block_start, &block_size, 4);
        record_offset[r + 1] = cursor - out;
    }
    return cursor - out;
}

// Concatenate spans from up to 255 arenas into `out` in piece order.
// Returns bytes written, or -(bytes required) when capacity is too small.
int64_t pq_concat_spans(
    int64_t n_pieces,
    const char* const* arenas,
    const uint8_t* piece_arena,
    const int64_t* piece_start,
    const int32_t* piece_len,
    char* out,
    int64_t out_capacity
) {
    int64_t required = 0;
    for (int64_t i = 0; i < n_pieces; ++i) required += piece_len[i];
    if (required > out_capacity) return -required;
    char* cursor = out;
    for (int64_t i = 0; i < n_pieces; ++i) {
        std::memcpy(cursor, arenas[piece_arena[i]] + piece_start[i], piece_len[i]);
        cursor += piece_len[i];
    }
    return cursor - out;
}

// One forward constant-start token of Rule::apply (transform.py fast
// path): dst[:, off:off+w] = src[:, start:start+w] with positions past
// each read's extent zeroed, and dst_len[r] += size[r]. src rows may be
// strided views into the parse arena (col stride must be 1).
void pq_apply_token(
    int32_t n,
    const uint8_t* src_code,
    const uint8_t* src_qual,
    int64_t src_row_stride,
    int64_t start,
    int32_t w,
    const int32_t* size,        // per-read copy extent, pre-clamped >= 0
    uint8_t* dst_code,
    uint8_t* dst_qual,
    int64_t dst_row_stride,
    int64_t dst_col_offset,
    int32_t* dst_len
) {
    switch (w) {
        case 8:
            apply_token_fixed<8>(n, src_code, src_qual, src_row_stride,
                                 start, size, dst_code, dst_qual,
                                 dst_row_stride, dst_col_offset, dst_len);
            return;
        case 10:
            apply_token_fixed<10>(n, src_code, src_qual, src_row_stride,
                                  start, size, dst_code, dst_qual,
                                  dst_row_stride, dst_col_offset, dst_len);
            return;
        case 16:
            apply_token_fixed<16>(n, src_code, src_qual, src_row_stride,
                                  start, size, dst_code, dst_qual,
                                  dst_row_stride, dst_col_offset, dst_len);
            return;
        default:
            break;
    }
    for (int32_t r = 0; r < n; ++r) {
        const int64_t src_off = static_cast<int64_t>(r) * src_row_stride + start;
        const int64_t dst_off =
            static_cast<int64_t>(r) * dst_row_stride + dst_col_offset;
        int32_t s = size[r];
        if (s > w) s = w;
        if (s > 0) {
            std::memcpy(dst_code + dst_off, src_code + src_off,
                        static_cast<size_t>(s));
            std::memcpy(dst_qual + dst_off, src_qual + src_off,
                        static_cast<size_t>(s));
        }
        if (s < w) {
            std::memset(dst_code + dst_off + s, 0, static_cast<size_t>(w - s));
            std::memset(dst_qual + dst_off + s, 0, static_cast<size_t>(w - s));
        }
        dst_len[r] += size[r];
    }
}

// Fused observation-span rendering for one decoder (mirrors the numpy
// fast path of engine/strict.py _observation_spans, byte-for-byte): for
// each read, write the raw barcode sequence (BAM nibble -> IUPAC ASCII)
// and quality (+33) of every observation segment consecutively into
// row-major (n, W_total) buffers; when panel pointers are present, also
// write the corrected barcode sequence/quality and per-read corrected
// lengths (decoded == 0 selects the all-zeros barcode; positions where
// the corrected code is 0 or matches the observed code keep the observed
// quality, every other position gets `corrected_quality`).
//   codes/quals[k] : (n, widths[k]) row-major uint8 observation matrices
//   seg_lens[k]    : per-read observation segment lengths
//   panel_segs[k]  : B x seg_widths[k] panel slice (row stride
//                    panel_stride); decoded r selects row decoded-1
// raw_lens: k==1 -> min(len, width); multi-segment -> W_total (the caller
// verified uniformity). cor_lens: sum_k min(len_k, min(widths[k],
// seg_widths[k])).
void pq_observation_spans(
    int32_t n,
    int32_t k_segments,
    const uint8_t* const* codes,
    const uint8_t* const* quals,
    const int32_t* const* seg_lens,
    const int32_t* widths,
    const uint8_t* const* panel_segs,
    int64_t panel_stride,
    const int32_t* seg_widths,
    const int32_t* decoded,
    uint8_t corrected_quality,
    uint8_t* raw_seq,
    uint8_t* raw_qual,
    int32_t* raw_lens,
    uint8_t* cor_seq,
    uint8_t* cor_qual,
    int32_t* cor_lens
) {
    int64_t w_total = 0;
    int64_t cw_total = 0;
    int32_t cw[16];
    for (int32_t k = 0; k < k_segments; ++k) {
        w_total += widths[k];
        if (cor_seq != nullptr) {
            cw[k] = widths[k] < seg_widths[k] ? widths[k] : seg_widths[k];
            cw_total += cw[k];
        }
    }
    for (int32_t r = 0; r < n; ++r) {
        uint8_t* seq_out = raw_seq + r * w_total;
        uint8_t* qual_out = raw_qual + r * w_total;
        for (int32_t k = 0; k < k_segments; ++k) {
            const int32_t w = widths[k];
            const uint8_t* code_row =
                codes[k] + static_cast<int64_t>(r) * w;
            const uint8_t* qual_row =
                quals[k] + static_cast<int64_t>(r) * w;
            for (int32_t i = 0; i < w; ++i) {
                seq_out[i] = static_cast<uint8_t>(
                    kBamToAscii[code_row[i] & 0xF]);
                qual_out[i] = static_cast<uint8_t>(qual_row[i] + 33);
            }
            seq_out += w;
            qual_out += w;
        }
        if (k_segments == 1) {
            int32_t l = seg_lens[0][r];
            raw_lens[r] = l < widths[0] ? l : widths[0];
        } else {
            raw_lens[r] = static_cast<int32_t>(w_total);
        }
        if (cor_seq == nullptr) continue;
        uint8_t* cseq_out = cor_seq + r * cw_total;
        uint8_t* cqual_out = cor_qual + r * cw_total;
        const int32_t d = decoded[r];
        int32_t clen = 0;
        for (int32_t k = 0; k < k_segments; ++k) {
            const int32_t w = widths[k];
            const int32_t ws = cw[k];
            const uint8_t* code_row =
                codes[k] + static_cast<int64_t>(r) * w;
            const uint8_t* qual_row =
                quals[k] + static_cast<int64_t>(r) * w;
            const uint8_t* barcode_row =
                d == 0 ? nullptr
                       : panel_segs[k] +
                             static_cast<int64_t>(d - 1) * panel_stride;
            for (int32_t i = 0; i < ws; ++i) {
                const uint8_t c = d == 0 ? 0 : barcode_row[i];
                cseq_out[i] = static_cast<uint8_t>(kBamToAscii[c & 0xF]);
                const bool keep = (code_row[i] == c) || (c == 0);
                cqual_out[i] = static_cast<uint8_t>(
                    (keep ? qual_row[i] : corrected_quality) + 33);
            }
            cseq_out += ws;
            cqual_out += ws;
            int32_t l = seg_lens[k][r];
            clen += l < ws ? l : ws;
        }
        cor_lens[r] = clen;
    }
}

// Format a batch of FASTQ records: '@name[ <seg>:<Y|N>:0:<BC>]\nSEQ\n+\nQUAL\n'.
// bc_* may be null (empty barcode spans). Returns bytes written or
// -(required).
int64_t pq_fastq_format_batch(
    int32_t n,
    const char* names,
    const int64_t* name_offset,
    const uint8_t* qcfail,
    int32_t segment_number,   // 1-based; 0 = omit the comment entirely
    const uint8_t* code,
    const uint8_t* qual,
    const int32_t* length,
    int32_t width,
    int32_t phred_offset,
    const char* bc_buffer,
    const int64_t* bc_start,
    const int32_t* bc_len,
    char* out,
    int64_t out_capacity,
    int64_t* rec_offset
) {
    int64_t required = 0;
    for (int32_t r = 0; r < n; ++r) {
        required += (name_offset[r + 1] - name_offset[r]) + 24 + 2 * length[r];
        if (bc_len != nullptr) required += bc_len[r];
    }
    if (required > out_capacity) return -required;
    char* cursor = out;
    rec_offset[0] = 0;
    for (int32_t r = 0; r < n; ++r) {
        *cursor++ = '@';
        int64_t name_length = name_offset[r + 1] - name_offset[r];
        std::memcpy(cursor, names + name_offset[r], name_length);
        cursor += name_length;
        if (segment_number > 0) {
            cursor += std::sprintf(cursor, " %d:%c:0:", segment_number,
                                   qcfail[r] ? 'Y' : 'N');
            if (bc_len != nullptr && bc_len[r] > 0) {
                std::memcpy(cursor, bc_buffer + bc_start[r], bc_len[r]);
                cursor += bc_len[r];
            }
        }
        *cursor++ = '\n';
        int32_t l = length[r] > width ? width : length[r];  // defense in depth
        const uint8_t* code_row = code + static_cast<int64_t>(r) * width;
        const uint8_t* qual_row = qual + static_cast<int64_t>(r) * width;
        for (int32_t i = 0; i < l; ++i) {
            cursor[i] = kBamToAscii[code_row[i] & 0xF];
        }
        cursor += l;
        *cursor++ = '\n';
        *cursor++ = '+';
        *cursor++ = '\n';
        for (int32_t i = 0; i < l; ++i) {
            cursor[i] = static_cast<char>(qual_row[i] + phred_offset);
        }
        cursor += l;
        *cursor++ = '\n';
        rec_offset[r + 1] = cursor - out;
    }
    return cursor - out;
}


// --- CRAM slice record decoder ----------------------------------------------
// Decodes one CRAM 3.0 slice's records into SoA batch buffers for the
// common demultiplexer layout: unmapped records, every consumed series in
// EXTERNAL streams (ITF-8 ints) or constant zero-bit Huffman, read names
// BYTE_ARRAY_STOP, bases/qualities EXTERNAL bytes, tags BYTE_ARRAY_LEN
// with length+value in one external stream (skipped, not reconstructed —
// input aux tags do not cross the demultiplexer in the reference either,
// transcode.h:206-215). Python walks containers and decompresses blocks
// (native rANS/zlib); this removes the per-record Python loop.
//
// Series descriptor codes: 0 = absent, 1 = EXTERNAL ITF-8 (stream index
// in `value`), 2 = constant (value in `value`).

struct CramStream {
    const uint8_t* data;
    int64_t size;
    int64_t offset;
};

static bool cram_itf8(CramStream* s, int32_t* out) {
    if (s->offset >= s->size) return false;
    uint8_t b0 = s->data[s->offset++];
    uint32_t v;
    int extra;
    if (b0 < 0x80) { v = b0; extra = 0; }
    else if (b0 < 0xC0) { v = b0 & 0x3F; extra = 1; }
    else if (b0 < 0xE0) { v = b0 & 0x1F; extra = 2; }
    else if (b0 < 0xF0) { v = b0 & 0x0F; extra = 3; }
    else { v = b0 & 0x0F; extra = 4; }
    if (s->offset + extra > s->size) return false;
    for (int i = 0; i < extra; ++i) {
        uint8_t byte = s->data[s->offset++];
        if (extra == 4 && i == 3) v = (v << 4) | (byte & 0x0F);
        else v = (v << 8) | byte;
    }
    *out = static_cast<int32_t>(v);
    return true;
}

// series descriptor: kinds[i] 0 absent / 1 external itf8 / 2 constant;
// values[i] = stream index or the constant
static bool cram_series_int(
    int32_t kind, int32_t value, CramStream* streams, int32_t* out
) {
    if (kind == 2) { *out = value; return true; }
    if (kind == 1) return cram_itf8(&streams[value], out);
    return false;
}

// Fixed-series order in the descriptor array:
// 0 BF, 1 CF, 2 RI, 3 RL, 4 AP, 5 RG, 6 MF, 7 NS, 8 NP, 9 TS, 10 NF, 11 TL
// Returns records decoded; -1 malformed; -3 record longer than max_length
// (caller grows and retries the WHOLE slice — streams are restartable).
int32_t pq_cram_decode_slice(
    int32_t n_records,
    const int32_t* series_kinds,        // (12,)
    const int32_t* series_values,       // (12,)
    int32_t rn_preserved,
    int32_t rn_stop,                    // stop byte for RN
    int32_t rn_stream,                  // RN stream index (-1 when absent)
    int32_t ba_stream,
    int32_t qs_stream,
    const uint8_t** stream_data,        // (k,)
    const int64_t* stream_sizes,        // (k,)
    int32_t n_streams,
    const int32_t* td_flat,             // concatenated tag stream ids per line
    const int32_t* td_offsets,          // (lines+1,)
    int32_t td_lines,
    int32_t max_length,
    uint8_t* code,                      // (n, max_length) BAM codes
    uint8_t* qual,
    int32_t* length,
    uint8_t* qcfail,
    char* names,
    int64_t names_capacity,
    int64_t* name_offset
) {
    std::vector<CramStream> streams(n_streams);
    for (int32_t k = 0; k < n_streams; ++k) {
        streams[k] = CramStream{stream_data[k], stream_sizes[k], 0};
    }
    int64_t names_used = 0;
    name_offset[0] = 0;
    for (int32_t r = 0; r < n_records; ++r) {
        if (names_capacity - names_used < 4096) return -1;
        int32_t bf, cf, rl;
        if (!cram_series_int(series_kinds[0], series_values[0], streams.data(), &bf)) return -1;
        if (!cram_series_int(series_kinds[1], series_values[1], streams.data(), &cf)) return -1;
        if (series_kinds[2] != 0) {  // RI (multi-ref slice)
            int32_t ri;
            if (!cram_series_int(series_kinds[2], series_values[2], streams.data(), &ri)) return -1;
        }
        if (!cram_series_int(series_kinds[3], series_values[3], streams.data(), &rl)) return -1;
        {
            int32_t ap;
            if (!cram_series_int(series_kinds[4], series_values[4], streams.data(), &ap)) return -1;
        }
        {
            int32_t rg;
            if (!cram_series_int(series_kinds[5], series_values[5], streams.data(), &rg)) return -1;
        }
        if (bf >= 0 && (bf & 0x4) == 0) return -1;  // mapped: python path
        if (rl < 0) return -1;
        // read name
        size_t name_length = 0;
        if (rn_preserved) {
            if (rn_stream < 0) return -1;
            CramStream* rn = &streams[rn_stream];
            int64_t start = rn->offset;
            while (rn->offset < rn->size &&
                   rn->data[rn->offset] != rn_stop) {
                ++rn->offset;
            }
            if (rn->offset >= rn->size) return -1;
            name_length = std::min<size_t>(rn->offset - start, 4000);
            std::memcpy(names + names_used, rn->data + start, name_length);
            ++rn->offset;  // consume the stop byte
        }
        int32_t mf = 0;
        if (cf & 2) {  // detached
            if (!cram_series_int(series_kinds[6], series_values[6], streams.data(), &mf)) return -1;
            if (!rn_preserved) {
                if (rn_stream < 0) return -1;
                CramStream* rn = &streams[rn_stream];
                int64_t start = rn->offset;
                while (rn->offset < rn->size &&
                       rn->data[rn->offset] != rn_stop) {
                    ++rn->offset;
                }
                if (rn->offset >= rn->size) return -1;
                name_length = std::min<size_t>(rn->offset - start, 4000);
                std::memcpy(names + names_used, rn->data + start, name_length);
                ++rn->offset;
            }
            int32_t scratch;
            if (!cram_series_int(series_kinds[7], series_values[7], streams.data(), &scratch)) return -1;
            if (!cram_series_int(series_kinds[8], series_values[8], streams.data(), &scratch)) return -1;
            if (!cram_series_int(series_kinds[9], series_values[9], streams.data(), &scratch)) return -1;
        } else if (cf & 4) {  // mate downstream
            int32_t nf;
            if (!cram_series_int(series_kinds[10], series_values[10], streams.data(), &nf)) return -1;
        }
        int32_t tl;
        if (!cram_series_int(series_kinds[11], series_values[11], streams.data(), &tl)) return -1;
        if (tl < 0 || tl >= td_lines) return -1;
        for (int32_t t = td_offsets[tl]; t < td_offsets[tl + 1]; ++t) {
            // BYTE_ARRAY_LEN with length+value in one stream: skip
            CramStream* tag = &streams[td_flat[t]];
            int32_t tag_length;
            if (!cram_itf8(tag, &tag_length)) return -1;
            if (tag_length < 0 || tag->offset + tag_length > tag->size) {
                return -1;
            }
            tag->offset += tag_length;
        }
        if (rl > max_length) return -3;  // caller grows + retries the slice
        uint8_t* code_row = code + static_cast<int64_t>(r) * max_length;
        uint8_t* qual_row = qual + static_cast<int64_t>(r) * max_length;
        if (cf & 8) {  // no sequence stored
            std::memset(code_row, 0, rl);
            std::memset(qual_row, 0, rl);
        } else {
            CramStream* ba = &streams[ba_stream];
            if (ba->offset + rl > ba->size) return -1;
            for (int32_t i = 0; i < rl; ++i) {
                code_row[i] = kAsciiToBam.table[ba->data[ba->offset + i]];
            }
            ba->offset += rl;
            if (cf & 1) {  // qualities stored
                CramStream* qs = &streams[qs_stream];
                if (qs->offset + rl > qs->size) return -1;
                // same classification quality-domain rule as the BAM
                // batch reader: 0xFF (missing sentinel) -> 0, clamp the
                // rest below 0x80 (the substitution LUT size)
                const uint8_t* src = qs->data + qs->offset;
                for (int32_t i = 0; i < rl; ++i) {
                    uint8_t q = src[i];
                    qual_row[i] = q == 0xFF ? 0 : (q & 0x80 ? 0x7F : q);
                }
                qs->offset += rl;
            } else {
                std::memset(qual_row, 0, rl);
            }
        }
        length[r] = rl;
        qcfail[r] = (bf & 0x200) ? 1 : 0;
        names_used += static_cast<int64_t>(name_length);
        name_offset[r + 1] = names_used;
    }
    return n_records;
}

// --- strict PAMLD classifier ------------------------------------------------
// Bit-exact C++ mirror of the float64 oracle (pheniqs_tpu/decode/oracle.py
// pamld_classify, itself the reference pamld.cpp:37-123): the LUT gathers
// and Kahan sums run in the same order with the same doubles, pow() hits
// the same libm, so results match the NumPy oracle to the last bit. This
// is the strict-mode worker hot loop (the classification half of
// --fidelity strict --threads N).

static const int8_t BRANCH_PASS_C = 0;
static const int8_t BRANCH_LOW_CONFIDENCE_C = 1;
static const int8_t BRANCH_NOISE_C = 2;

void pq_pamld_classify(
    int64_t n,
    int32_t w,
    int32_t b,
    const uint8_t* obs_code,      // (n, w) effective observation codes
    const uint8_t* obs_qual,      // (n, w) effective observation qualities
    const uint8_t* panel,         // (b, w) barcode codes
    const double* concentration,  // (b,)
    const double* lut,            // (128, 16, 16) substitution LUT, f64
    double noise_times_rbp,       // spec.noise * random barcode probability
    double random_barcode_probability,
    double confidence_threshold,
    int32_t hq_threshold,
    int32_t hqd_threshold,
    const uint8_t* qcfail_in,     // (n,)
    int32_t* decoded,             // (n,) out: 0 unclassified, 1..b
    double* confidence,           // (n,) out
    int32_t* distance,            // (n,) out
    uint8_t* qcfail_out,          // (n,) out
    int8_t* branch,               // (n,) out
    int32_t* argmax_out           // (n,) out: pre-noise-filter argmax
) {
    const double phred_base = std::pow(10.0, -0.1);
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* oc = obs_code + r * w;
        const uint8_t* oq = obs_qual + r * w;

        // posterior accumulation over barcodes in codec order
        double sigma_p = 0.0, comp = 0.0, best_p = 0.0;
        int32_t best_index = 0;  // 1-based; 0 until any p > 0
        double best_conditional = 0.0;
        int32_t best_distance = 0, best_hqd = 0;
        for (int32_t j = 0; j < b; ++j) {
            const uint8_t* ec = panel + static_cast<int64_t>(j) * w;
            // Kahan over positions, LUT gather order matches the oracle
            double sigma_q = 0.0, qcomp = 0.0;
            for (int32_t i = 0; i < w; ++i) {
                double term = lut[(static_cast<int64_t>(oq[i]) << 8)
                                  | (static_cast<int64_t>(ec[i] & 0xF) << 4)
                                  | (oc[i] & 0xF)];
                double y = term - qcomp;
                double t = sigma_q + y;
                qcomp = (t - sigma_q) - y;
                sigma_q = t;
            }
            double conditional = std::pow(phred_base, sigma_q);
            double p = conditional * concentration[j];
            double y = p - comp;
            double t = sigma_p + y;
            comp = (t - sigma_p) - y;
            sigma_p = t;
            if (p > best_p) {
                best_p = p;
                best_index = j + 1;
                best_conditional = conditional;
                int32_t dist = 0, hqd = 0;
                for (int32_t i = 0; i < w; ++i) {
                    if (ec[i] != oc[i]) {
                        ++dist;
                        if (oq[i] >= hq_threshold) ++hqd;
                    }
                }
                best_distance = dist;
                best_hqd = hqd;
            }
        }
        {
            // noise term folded in with the final compensation, matching
            // the oracle's last partial Kahan step exactly
            double y = noise_times_rbp - comp;
            sigma_p = sigma_p + y;
        }
        double conf = best_p / sigma_p;

        bool none_decoded = best_index == 0;
        double conditional_decoded = none_decoded ? 0.0 : best_conditional;
        int32_t dist_decoded = none_decoded ? 0 : best_distance;
        int32_t hqd_decoded = none_decoded ? 0 : best_hqd;

        bool passed_noise = conditional_decoded > random_barcode_probability;
        bool passed_confidence = conf > confidence_threshold;

        uint8_t fail = qcfail_in[r];
        int8_t br = BRANCH_PASS_C;
        int32_t dec = best_index;
        double out_conf = conf;
        int32_t out_dist = dist_decoded;
        if (!passed_noise) {
            br = BRANCH_NOISE_C;
            fail = 1;
            dec = 0;
            out_conf = 0.0;
            out_dist = 0;
        } else if (!passed_confidence) {
            br = BRANCH_LOW_CONFIDENCE_C;
            fail = 1;
        } else if (hqd_threshold > 0 && hqd_decoded >= hqd_threshold) {
            fail = 1;
        }
        decoded[r] = dec;
        confidence[r] = out_conf;
        distance[r] = out_dist;
        qcfail_out[r] = fail;
        branch[r] = br;
        argmax_out[r] = best_index;
    }
}

// --- strict MDD classifier --------------------------------------------------
// Integer-exact C++ mirror of the minimum-distance oracle
// (decode/oracle.py mdd_classify, reference mdd.cpp:37-86): exact-match
// scan first (full-length equality, first hit in codec order), then the
// first barcode whose per-segment error counts fit the tolerances — NOT
// the closest. Positions past min(observation width, length) are never
// compared (reference sequence.h:90-98 iterates the observation length).

void pq_mdd_classify(
    int64_t n,
    int32_t s,
    int32_t b,
    const uint8_t* obs_code,      // (n, obs_stride) segment-concatenated
    const uint8_t* obs_qual,      // (n, obs_stride)
    int32_t obs_stride,
    const int32_t* obs_widths,    // (s,)
    const int32_t* lengths,       // (n, s)
    const uint8_t* panel,         // (b, panel_stride) segment-concatenated
    int32_t panel_stride,
    const int32_t* panel_widths,  // (s,)
    const int32_t* tolerance,     // (s,)
    int32_t quality_masking_threshold,
    const uint8_t* qcfail_in,
    int32_t* decoded,
    int32_t* distance,
    uint8_t* qcfail_out
) {
    // per-segment offsets into the concatenated layouts
    std::vector<int32_t> obs_at(s), panel_at(s);
    int32_t oa = 0, pa = 0;
    for (int32_t k = 0; k < s; ++k) {
        obs_at[k] = oa;
        panel_at[k] = pa;
        oa += obs_widths[k];
        pa += panel_widths[k];
    }
    for (int64_t r = 0; r < n; ++r) {
        const uint8_t* oc = obs_code + r * obs_stride;
        const uint8_t* oq = obs_qual + r * obs_stride;
        const int32_t* len = lengths + r * s;
        int32_t dec = 0, dist = 0;

        // pass 1: exact match (first in codec order)
        for (int32_t j = 0; j < b && dec == 0; ++j) {
            const uint8_t* ec = panel + static_cast<int64_t>(j) * panel_stride;
            bool exact = true;
            for (int32_t k = 0; k < s && exact; ++k) {
                if (len[k] != panel_widths[k]) { exact = false; break; }
                int32_t limit = std::min(obs_widths[k], len[k]);
                const uint8_t* o = oc + obs_at[k];
                const uint8_t* e = ec + panel_at[k];
                for (int32_t p = 0; p < limit; ++p) {
                    if (o[p] != e[p]) { exact = false; break; }
                }
            }
            if (exact) dec = j + 1;  // distance stays 0
        }
        // pass 2: first barcode within per-segment tolerance
        if (dec == 0) {
            for (int32_t j = 0; j < b && dec == 0; ++j) {
                const uint8_t* ec =
                    panel + static_cast<int64_t>(j) * panel_stride;
                bool within = true;
                int32_t total = 0;
                for (int32_t k = 0; k < s && within; ++k) {
                    int32_t limit = std::min(obs_widths[k], len[k]);
                    const uint8_t* o = oc + obs_at[k];
                    const uint8_t* q = oq + obs_at[k];
                    const uint8_t* e = ec + panel_at[k];
                    int32_t err = 0;
                    for (int32_t p = 0; p < limit; ++p) {
                        bool bad = o[p] != e[p];
                        if (quality_masking_threshold > 0 &&
                            q[p] < quality_masking_threshold) {
                            bad = true;
                        }
                        if (bad) ++err;
                    }
                    if (err > tolerance[k]) within = false;
                    total += err;
                }
                if (within) { dec = j + 1; dist = total; }
            }
        }
        decoded[r] = dec;
        distance[r] = dist;
        qcfail_out[r] = qcfail_in[r] | (dec == 0 ? 1 : 0);
    }
}

// --- rANS 4x8 (CRAM 3.0 method 4) -----------------------------------------
// Same wire format as pheniqs_tpu/io/rans.py (see its docstring): 12-bit
// frequencies, four interleaved states, byte renormalization at 2^23.

static const uint32_t RANS_TOTFREQ = 4096;
static const uint32_t RANS_LOW = 1u << 23;

static void rans_normalize(int64_t* counts, int64_t* freqs) {
    int64_t total = 0;
    for (int i = 0; i < 256; ++i) total += counts[i];
    if (total == 0) { for (int i = 0; i < 256; ++i) freqs[i] = 0; return; }
    int64_t sum = 0;
    for (int i = 0; i < 256; ++i) {
        freqs[i] = static_cast<int64_t>(counts[i] * (RANS_TOTFREQ / static_cast<double>(total)));
        if (counts[i] > 0 && freqs[i] == 0) freqs[i] = 1;
        sum += freqs[i];
    }
    int largest = 0;
    for (int i = 1; i < 256; ++i) if (freqs[i] > freqs[largest]) largest = i;
    freqs[largest] += RANS_TOTFREQ - sum;
}

static uint8_t* rans_put_freq(uint8_t* cp, int64_t v) {
    if (v < 0x80) { *cp++ = static_cast<uint8_t>(v); }
    else { *cp++ = static_cast<uint8_t>((v >> 8) | 0x80); *cp++ = static_cast<uint8_t>(v & 0xFF); }
    return cp;
}

// Bounded variant: returns nullptr if reading the frequency would run past
// `end` (crafted/truncated streams must fail typed, not read out of bounds).
static const uint8_t* rans_get_freq(const uint8_t* cp, const uint8_t* end, int64_t* v) {
    if (cp >= end) return nullptr;
    if (*cp < 0x80) { *v = *cp++; }
    else {
        if (end - cp < 2) return nullptr;
        *v = (static_cast<int64_t>(cp[0] & 0x7F) << 8) | cp[1]; cp += 2;
    }
    return cp;
}

static uint8_t* rans_put_table(uint8_t* cp, const int64_t* freqs) {
    int rle = 0;
    for (int j = 0; j < 256; ++j) {
        if (!freqs[j]) continue;
        if (rle) { --rle; }
        else {
            *cp++ = static_cast<uint8_t>(j);
            if (j > 0 && freqs[j - 1] > 0) {
                int run = j + 1;
                while (run < 256 && freqs[run] > 0) ++run;
                rle = run - j - 1;
                *cp++ = static_cast<uint8_t>(rle);
            }
        }
        cp = rans_put_freq(cp, freqs[j]);
    }
    *cp++ = 0;
    return cp;
}

// Parses one 256-symbol frequency table. Returns nullptr on any malformed
// input: truncation, RLE runs walking the symbol index past 255, or (checked
// by the caller via rans_freqs_valid) frequencies not summing to TOTFREQ.
static const uint8_t* rans_get_table(const uint8_t* cp, const uint8_t* end,
                                     int64_t* freqs) {
    for (int i = 0; i < 256; ++i) freqs[i] = 0;
    int rle = 0;
    if (cp >= end) return nullptr;
    int sym = *cp++;
    for (;;) {
        cp = rans_get_freq(cp, end, &freqs[sym]);
        if (cp == nullptr) return nullptr;
        if (rle > 0) {
            --rle;
            if (++sym > 255) return nullptr;
        } else {
            if (cp >= end) return nullptr;
            if (*cp == sym + 1) {
                if (end - cp < 2) return nullptr;
                sym = *cp++; rle = *cp++;
            } else {
                sym = *cp++;
                if (sym == 0) break;
            }
        }
    }
    return cp;
}

// A decodable table's frequencies must sum to exactly RANS_TOTFREQ; anything
// else would let rans_cumulate build cum[] past the 4096-entry lookup.
static bool rans_freqs_valid(const int64_t* freqs) {
    int64_t sum = 0;
    for (int i = 0; i < 256; ++i) {
        if (freqs[i] < 0 || freqs[i] > static_cast<int64_t>(RANS_TOTFREQ)) return false;
        sum += freqs[i];
    }
    return sum == static_cast<int64_t>(RANS_TOTFREQ);
}

struct RansEnc {
    uint32_t x = RANS_LOW;
    // bytes emitted back-to-front into a shared reversed buffer
    void put(std::vector<uint8_t>& rev, uint32_t start, uint32_t freq) {
        uint32_t x_max = ((RANS_LOW >> 12) << 8) * freq;
        while (x >= x_max) { rev.push_back(x & 0xFF); x >>= 8; }
        x = ((x / freq) << 12) + (x % freq) + start;
    }
    void flush(std::vector<uint8_t>& rev) {
        rev.push_back((x >> 24) & 0xFF); rev.push_back((x >> 16) & 0xFF);
        rev.push_back((x >> 8) & 0xFF); rev.push_back(x & 0xFF);
    }
};

static void rans_cumulate(const int64_t* freqs, uint32_t* cum, uint8_t* lookup) {
    cum[0] = 0;
    for (int i = 0; i < 256; ++i) cum[i + 1] = cum[i] + static_cast<uint32_t>(freqs[i]);
    if (lookup) {
        for (int s = 0; s < 256; ++s)
            for (uint32_t k = cum[s]; k < cum[s + 1]; ++k) lookup[k] = static_cast<uint8_t>(s);
    }
}

struct RansDec {
    uint32_t x;
    void init(const uint8_t*& cp) {
        x = static_cast<uint32_t>(cp[0]) | (cp[1] << 8) | (cp[2] << 16)
            | (static_cast<uint32_t>(cp[3]) << 24);
        cp += 4;
    }
    inline void advance(const uint8_t*& cp, const uint8_t* end,
                        uint32_t freq, uint32_t slot, uint32_t cum) {
        x = freq * (x >> 12) + slot - cum;
        while (x < RANS_LOW && cp < end) x = (x << 8) | *cp++;
    }
};

// returns bytes written, or -1 on insufficient capacity
int64_t pq_rans_compress(const uint8_t* in, int64_t in_size, int order,
                         uint8_t* out, int64_t capacity) {
    if (in_size < 4) order = 0;
    std::vector<uint8_t> table;
    std::vector<uint8_t> rev;
    rev.reserve(static_cast<size_t>(in_size) + 64);
    if (in_size > 0 && order == 0) {
        int64_t counts[256] = {0}, freqs[256];
        for (int64_t i = 0; i < in_size; ++i) counts[in[i]]++;
        rans_normalize(counts, freqs);
        uint32_t cum[257];
        rans_cumulate(freqs, cum, nullptr);
        table.resize(256 * 3 + 2);
        table.resize(rans_put_table(table.data(), freqs) - table.data());
        RansEnc states[4];
        for (int64_t i = in_size - 1; i >= 0; --i) {
            int s = in[i];
            states[i & 3].put(rev, cum[s], static_cast<uint32_t>(freqs[s]));
        }
        for (int j = 3; j >= 0; --j) states[j].flush(rev);
    } else if (in_size > 0) {
        // order-1: 256 contexts, quarters restart at context 0
        std::vector<int64_t> counts(256 * 256, 0), freqs(256 * 256, 0);
        std::vector<uint32_t> cum(256 * 257, 0);
        int64_t quarter = in_size >> 2;
        counts[0 * 256 + in[0]]++;
        for (int64_t i = 1; i < in_size; ++i) counts[in[i - 1] * 256 + in[i]]++;
        for (int j = 1; j <= 3; ++j) counts[0 * 256 + in[j * quarter]]++;
        bool present[256];
        for (int c = 0; c < 256; ++c) {
            int64_t total = 0;
            for (int s = 0; s < 256; ++s) total += counts[c * 256 + s];
            present[c] = total > 0;
            if (present[c]) {
                rans_normalize(&counts[c * 256], &freqs[c * 256]);
                rans_cumulate(&freqs[c * 256], &cum[c * 257], nullptr);
            }
        }
        table.resize(257u * (256 * 3 + 4));
        uint8_t* cp = table.data();
        int rle = 0;
        for (int c = 0; c < 256; ++c) {
            if (!present[c]) continue;
            if (rle) { --rle; }
            else {
                *cp++ = static_cast<uint8_t>(c);
                if (c > 0 && present[c - 1]) {
                    int run = c + 1;
                    while (run < 256 && present[run]) ++run;
                    rle = run - c - 1;
                    *cp++ = static_cast<uint8_t>(rle);
                }
            }
            cp = rans_put_table(cp, &freqs[c * 256]);
        }
        *cp++ = 0;
        table.resize(cp - table.data());

        RansEnc states[4];
        int64_t idx[4] = {quarter - 2, 2 * quarter - 2, 3 * quarter - 2, in_size - 2};
        int last[4] = {in[quarter - 1], in[2 * quarter - 1], in[3 * quarter - 1],
                       in[in_size - 1]};
        while (idx[3] > 4 * quarter - 2) {
            int ctx = in[idx[3]];
            states[3].put(rev, cum[ctx * 257 + last[3]],
                          static_cast<uint32_t>(freqs[ctx * 256 + last[3]]));
            last[3] = ctx;
            --idx[3];
        }
        while (idx[0] >= 0) {
            for (int j = 3; j >= 0; --j) {
                int ctx = in[idx[j]];
                states[j].put(rev, cum[ctx * 257 + last[j]],
                              static_cast<uint32_t>(freqs[ctx * 256 + last[j]]));
                last[j] = ctx;
                --idx[j];
            }
        }
        for (int j = 3; j >= 0; --j)
            states[j].put(rev, cum[0 * 257 + last[j]],
                          static_cast<uint32_t>(freqs[0 * 256 + last[j]]));
        for (int j = 3; j >= 0; --j) states[j].flush(rev);
    }
    int64_t payload = static_cast<int64_t>(table.size() + rev.size());
    if (9 + payload > capacity) return -1;
    out[0] = (order == 1 && in_size >= 4) ? 1 : 0;
    uint32_t csz = static_cast<uint32_t>(payload), rsz = static_cast<uint32_t>(in_size);
    memcpy(out + 1, &csz, 4);
    memcpy(out + 5, &rsz, 4);
    memcpy(out + 9, table.data(), table.size());
    uint8_t* cp = out + 9 + table.size();
    for (size_t i = rev.size(); i > 0; --i) *cp++ = rev[i - 1];
    return 9 + payload;
}

// returns raw size written, -1 on capacity, -2 on malformed stream
int64_t pq_rans_uncompress(const uint8_t* in, int64_t in_size,
                           uint8_t* out, int64_t capacity) {
    if (in_size < 9) return -2;
    int order = in[0];
    uint32_t rsz;
    memcpy(&rsz, in + 5, 4);
    if (rsz > static_cast<uint64_t>(capacity)) return -1;
    if (rsz == 0) return 0;
    const uint8_t* cp = in + 9;
    const uint8_t* end = in + in_size;
    if (order == 0) {
        int64_t freqs[256];
        cp = rans_get_table(cp, end, freqs);
        if (cp == nullptr || !rans_freqs_valid(freqs)) return -2;
        uint32_t cum[257];
        std::vector<uint8_t> lookup(RANS_TOTFREQ);
        rans_cumulate(freqs, cum, lookup.data());
        if (end - cp < 16) return -2;  // 4 interleaved states x 4 bytes
        RansDec states[4];
        for (int j = 0; j < 4; ++j) states[j].init(cp);
        for (uint32_t i = 0; i < rsz; ++i) {
            RansDec& st = states[i & 3];
            uint32_t slot = st.x & (RANS_TOTFREQ - 1);
            uint8_t sym = lookup[slot];
            out[i] = sym;
            st.advance(cp, end, static_cast<uint32_t>(freqs[sym]), slot, cum[sym]);
        }
        return rsz;
    }
    if (order != 1) return -2;
    std::vector<int64_t> freqs(256 * 256, 0);
    std::vector<uint32_t> cum(256 * 257, 0);
    std::vector<uint8_t> lookup(256 * RANS_TOTFREQ, 0);
    bool present[256] = {false};
    {
        int rle = 0;
        if (cp >= end) return -2;
        int ctx = *cp++;
        for (;;) {
            cp = rans_get_table(cp, end, &freqs[ctx * 256]);
            if (cp == nullptr || !rans_freqs_valid(&freqs[ctx * 256])) return -2;
            present[ctx] = true;
            rans_cumulate(&freqs[ctx * 256], &cum[ctx * 257],
                          &lookup[static_cast<size_t>(ctx) * RANS_TOTFREQ]);
            if (rle > 0) {
                --rle;
                if (++ctx > 255) return -2;
            } else {
                if (cp >= end) return -2;
                if (*cp == ctx + 1) {
                    if (end - cp < 2) return -2;
                    ctx = *cp++; rle = *cp++;
                } else {
                    ctx = *cp++;
                    if (ctx == 0) break;
                }
            }
        }
    }
    if (end - cp < 16) return -2;  // 4 interleaved states x 4 bytes
    RansDec states[4];
    for (int j = 0; j < 4; ++j) states[j].init(cp);
    uint32_t quarter = rsz >> 2;
    int last[4] = {0, 0, 0, 0};
    for (uint32_t i = 0; i < quarter; ++i) {
        for (int j = 0; j < 4; ++j) {
            RansDec& st = states[j];
            uint32_t slot = st.x & (RANS_TOTFREQ - 1);
            int ctx = last[j];
            if (!present[ctx]) return -2;  // crafted stream references absent context
            uint8_t sym = lookup[static_cast<size_t>(ctx) * RANS_TOTFREQ + slot];
            out[j * quarter + i] = sym;
            st.advance(cp, end, static_cast<uint32_t>(freqs[ctx * 256 + sym]),
                       slot, cum[ctx * 257 + sym]);
            last[j] = sym;
        }
    }
    for (uint32_t i = 4 * quarter; i < rsz; ++i) {
        RansDec& st = states[3];
        uint32_t slot = st.x & (RANS_TOTFREQ - 1);
        int ctx = last[3];
        if (!present[ctx]) return -2;
        uint8_t sym = lookup[static_cast<size_t>(ctx) * RANS_TOTFREQ + slot];
        out[i] = sym;
        st.advance(cp, end, static_cast<uint32_t>(freqs[ctx * 256 + sym]),
                   slot, cum[ctx * 257 + sym]);
        last[3] = sym;
    }
    return rsz;
}

// --- host->device wire packer -----------------------------------------------
// Byte-for-byte mirror of device/step.py pack_h2d_blob's numpy path (parity
// pinned by tests): 4-bit codes nibble-packed two per byte, 6-bit qualities
// packed four into three bytes (clamped at 63; any quality over 63 ORs
// H2D_FORCED=4 into `flags`), then the clipped length.  One call per
// segment; `flags` (n bytes) accumulates across segments and the caller
// writes it into the final blob column.  Runs with the GIL released
// (ctypes), so the parent's packing overlaps worker rendering.
void pq_pack_h2d_segment(
    const uint8_t* code, const uint8_t* qual, const int32_t* length,
    int64_t n, int64_t sw, int64_t w,
    uint8_t* blob, int64_t blob_stride, int64_t offset,
    int64_t length_bytes, uint8_t* flags) {
    const int64_t cw = w / 2;
    const int64_t qw = (3 * w) / 4;
    const int64_t full = sw < w ? sw / 2 : cw;   // byte pairs fully inside sw
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* c = code + i * sw;
        const uint8_t* q = qual + i * sw;
        uint8_t* row = blob + i * blob_stride + offset;
        for (int64_t j = 0; j < full; ++j) {
            row[j] = static_cast<uint8_t>(c[2 * j] | (c[2 * j + 1] << 4));
        }
        for (int64_t j = full; j < cw; ++j) {
            const int64_t a = 2 * j, b = 2 * j + 1;
            const uint8_t lo = a < sw ? c[a] : 0;
            const uint8_t hi = b < sw ? c[b] : 0;
            row[j] = static_cast<uint8_t>(lo | (hi << 4));
        }
        uint8_t* qrow = row + cw;
        bool forced = false;
        for (int64_t g = 0; g < w / 4; ++g) {
            uint8_t v[4];
            for (int k = 0; k < 4; ++k) {
                const int64_t s = 4 * g + k;
                uint8_t x = s < sw ? q[s] : 0;
                if (x > 63) { forced = true; x = 63; }
                v[k] = x;
            }
            qrow[3 * g] = static_cast<uint8_t>(v[0] | (v[1] << 6));
            qrow[3 * g + 1] = static_cast<uint8_t>((v[1] >> 2) | (v[2] << 4));
            qrow[3 * g + 2] = static_cast<uint8_t>((v[2] >> 4) | (v[3] << 2));
        }
        if (forced) flags[i] |= 4;  // H2D_FORCED (device/step.py)
        int32_t len = length[i];
        if (len < 0) len = 0;
        if (len > w) len = static_cast<int32_t>(w);
        uint8_t* lrow = qrow + qw;
        lrow[0] = static_cast<uint8_t>(len & 0xFF);
        if (length_bytes == 2) lrow[1] = static_cast<uint8_t>(len >> 8);
    }
}

// Codebook variant of pq_pack_h2d_segment (wire v3, device/step.py):
// qualities are mapped through lut_idx (256 -> nearest codebook index)
// and packed at 2 or 4 bits each; any position WITHIN the read's length
// whose quality the codebook cannot represent exactly (lut_exact == 0)
// ORs H2D_FORCED into `flags` so the hybrid engine re-resolves the row
// with the float64 oracle. Byte-identical to the numpy path (parity
// pinned by tests/test_device_classify.py).
void pq_pack_h2d_segment_cb(
    const uint8_t* code, const uint8_t* qual, const int32_t* length,
    int64_t n, int64_t sw, int64_t w,
    uint8_t* blob, int64_t blob_stride, int64_t offset,
    int64_t length_bytes, uint8_t* flags,
    int64_t qual_bits, const uint8_t* lut_idx, const uint8_t* lut_exact) {
    const int64_t cw = w / 2;
    const int64_t qw = qual_bits == 2 ? w / 4 : w / 2;
    const int64_t full = sw < w ? sw / 2 : cw;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* c = code + i * sw;
        const uint8_t* q = qual + i * sw;
        uint8_t* row = blob + i * blob_stride + offset;
        for (int64_t j = 0; j < full; ++j) {
            row[j] = static_cast<uint8_t>(c[2 * j] | (c[2 * j + 1] << 4));
        }
        for (int64_t j = full; j < cw; ++j) {
            const int64_t a = 2 * j, b = 2 * j + 1;
            const uint8_t lo = a < sw ? c[a] : 0;
            const uint8_t hi = b < sw ? c[b] : 0;
            row[j] = static_cast<uint8_t>(lo | (hi << 4));
        }
        uint8_t* qrow = row + cw;
        int32_t len = length[i];
        if (len < 0) len = 0;
        if (len > w) len = static_cast<int32_t>(w);
        bool forced = false;
        if (qual_bits == 2) {
            for (int64_t g = 0; g < w / 4; ++g) {
                uint8_t byte = 0;
                for (int k = 0; k < 4; ++k) {
                    const int64_t s = 4 * g + k;
                    const uint8_t x = s < sw ? q[s] : 0;
                    if (s < len && !lut_exact[x]) forced = true;
                    byte |= static_cast<uint8_t>(lut_idx[x] << (2 * k));
                }
                qrow[g] = byte;
            }
        } else {  // 4-bit indices, two per byte
            for (int64_t g = 0; g < w / 2; ++g) {
                uint8_t byte = 0;
                for (int k = 0; k < 2; ++k) {
                    const int64_t s = 2 * g + k;
                    const uint8_t x = s < sw ? q[s] : 0;
                    if (s < len && !lut_exact[x]) forced = true;
                    byte |= static_cast<uint8_t>(lut_idx[x] << (4 * k));
                }
                qrow[g] = byte;
            }
        }
        if (forced) flags[i] |= 4;  // H2D_FORCED
        uint8_t* lrow = qrow + qw;
        lrow[0] = static_cast<uint8_t>(len & 0xFF);
        if (length_bytes == 2) lrow[1] = static_cast<uint8_t>(len >> 8);
    }
}

// Joint (code, quality) pair-codebook variant (wire j4, device/step.py):
// both lanes collapse into one 4-bit pair-index lane. lut_idx/lut_exact
// are the 4096-entry ((code & 15) << 8 | quality) tables from
// sense_joint_codebook; inexact pairs WITHIN the read's length OR
// H2D_FORCED into `flags` (f64 oracle re-resolution contract).
// Byte-identical to the numpy path.
void pq_pack_h2d_segment_j4(
    const uint8_t* code, const uint8_t* qual, const int32_t* length,
    int64_t n, int64_t sw, int64_t w,
    uint8_t* blob, int64_t blob_stride, int64_t offset,
    int64_t length_bytes, uint8_t* flags,
    const uint8_t* lut_idx, const uint8_t* lut_exact) {
    const int64_t qw = w / 2;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* c = code + i * sw;
        const uint8_t* q = qual + i * sw;
        uint8_t* row = blob + i * blob_stride + offset;
        int32_t len = length[i];
        if (len < 0) len = 0;
        if (len > w) len = static_cast<int32_t>(w);
        bool forced = false;
        for (int64_t g = 0; g < qw; ++g) {
            uint8_t byte = 0;
            for (int k = 0; k < 2; ++k) {
                const int64_t s = 2 * g + k;
                const int32_t key =
                    s < sw ? (((c[s] & 15) << 8) | q[s]) : 0;
                if (s < len && !lut_exact[key]) forced = true;
                byte |= static_cast<uint8_t>(lut_idx[key] << (4 * k));
            }
            row[g] = byte;
        }
        if (forced) flags[i] |= 4;  // H2D_FORCED
        uint8_t* lrow = row + qw;
        lrow[0] = static_cast<uint8_t>(len & 0xFF);
        if (length_bytes == 2) lrow[1] = static_cast<uint8_t>(len >> 8);
    }
}

// ---------------------------------------------------------------------------
// rANS Nx16 (CRAM 3.1, hts-specs CRAMcodecs): the hot order-0/1 core with
// 4/32-way interleave, byte-compatible with pheniqs_tpu/io/rans_nx16.py
// (same alphabet RLE, normalisation tie-breaks, state order and word-
// reversed renorm payload, so native and Python writers emit identical
// streams). Transform flags (PACK/RLE/CAT/STRIPE/NOSZ) stay in Python —
// the wrappers return -3 so the caller falls back.

static const uint32_t NX16_TOT = 4096;     // 12-bit order-0 frequencies
static const uint32_t NX16_L = 1u << 15;   // state lower bound, 16-bit renorm

static uint8_t* nx16_put_uint7(uint8_t* cp, uint64_t v) {
    uint8_t tmp[10];
    int n = 0;
    tmp[n++] = v & 0x7F;
    v >>= 7;
    while (v) { tmp[n++] = 0x80 | (v & 0x7F); v >>= 7; }
    for (int i = n - 1; i >= 0; --i) *cp++ = tmp[i];
    return cp;
}

static const uint8_t* nx16_get_uint7(const uint8_t* cp, const uint8_t* end,
                                     uint64_t* v) {
    *v = 0;
    for (;;) {
        if (cp >= end) return nullptr;
        uint8_t b = *cp++;
        *v = (*v << 7) | (b & 0x7F);
        if (!(b & 0x80)) return cp;
    }
}

// ascending alphabet with consecutive-run bytes, 0-terminated (mirrors
// rans_nx16._put_alphabet / _get_alphabet)
static uint8_t* nx16_put_alphabet(uint8_t* cp, const int* syms, int count) {
    int i = 0, last = -2;
    while (i < count) {
        int sym = syms[i];
        *cp++ = static_cast<uint8_t>(sym);
        if (sym == last + 1) {
            int run = 0;
            while (i + run + 1 < count && syms[i + run + 1] == sym + run + 1)
                ++run;
            *cp++ = static_cast<uint8_t>(run);
            i += run + 1;
            last = sym + run;
        } else {
            last = sym;
            ++i;
        }
    }
    *cp++ = 0;
    return cp;
}

static const uint8_t* nx16_get_alphabet(const uint8_t* cp, const uint8_t* end,
                                        int* syms, int* count) {
    *count = 0;
    int rle = 0, last = -2;
    if (cp >= end) return nullptr;
    int sym = *cp++;
    for (;;) {
        // a crafted RLE run must not walk the symbol value past 255:
        // callers index 256-entry frequency tables with it
        if (*count >= 256 || sym > 255) return nullptr;
        syms[(*count)++] = sym;
        if (rle > 0) {
            --rle;
            ++sym;
            last = sym - 1;
        } else {
            last = sym;
            if (cp >= end) return nullptr;
            sym = *cp++;
            if (sym == last + 1) {
                if (cp >= end) return nullptr;
                rle = *cp++;
            }
        }
        if (rle == 0 && sym <= last) {
            if (sym != 0) return nullptr;
            break;
        }
    }
    return cp;
}

// scale to `target` keeping nonzero entries >= 1; remainder to the most
// frequent (smaller symbol wins ties) — mirrors rans_nx16._normalize
static void nx16_normalize(int64_t* freqs, const int* syms, int count,
                           uint32_t target) {
    int64_t total = 0;
    for (int i = 0; i < count; ++i) total += freqs[syms[i]];
    if (total == 0 || total == static_cast<int64_t>(target)) return;
    int64_t sum = 0;
    int top = syms[0];
    for (int i = 0; i < count; ++i) {
        int s = syms[i];
        int64_t f = (freqs[s] * target) / total;
        if (f < 1) f = 1;
        freqs[s] = f;
        sum += f;
        if (f > freqs[top]) top = s;  // ascending scan: ties keep smaller
    }
    freqs[top] += target - sum;
}

struct Nx16Enc {
    uint32_t x = NX16_L;
    void put(std::vector<uint16_t>& words, uint32_t start, uint32_t freq,
             int shift) {
        uint32_t x_max = ((NX16_L >> shift) << 16) * freq;
        while (x >= x_max) {
            words.push_back(static_cast<uint16_t>(x & 0xFFFF));
            x >>= 16;
        }
        x = ((x / freq) << shift) + (x % freq) + start;
    }
};

struct Nx16Dec {
    uint32_t x;
    void init(const uint8_t*& cp) {
        x = static_cast<uint32_t>(cp[0]) | (cp[1] << 8) | (cp[2] << 16)
            | (static_cast<uint32_t>(cp[3]) << 24);
        cp += 4;
    }
    inline bool advance(const uint8_t*& cp, const uint8_t* end,
                        uint32_t freq, uint32_t slot, uint32_t cum,
                        int shift) {
        x = freq * (x >> shift) + slot - cum;
        if (x < NX16_L) {
            if (end - cp < 2) return false;
            x = (x << 16) | (static_cast<uint32_t>(cp[0]) | (cp[1] << 8));
            cp += 2;
        }
        return true;
    }
};

// order-0 body (no wrapper flags byte / size): table + states + payload
static void nx16_o0_body(const uint8_t* in, int64_t n, int n_states,
                         std::vector<uint8_t>& out) {
    int64_t freqs[256] = {0};
    for (int64_t i = 0; i < n; ++i) freqs[in[i]]++;
    int syms[256], count = 0;
    for (int s = 0; s < 256; ++s)
        if (freqs[s]) syms[count++] = s;
    if (count == 0) { syms[count++] = 0; freqs[0] = 1; }
    nx16_normalize(freqs, syms, count, NX16_TOT);
    uint32_t cum[256];
    {
        uint32_t acc = 0;
        for (int i = 0; i < count; ++i) { cum[syms[i]] = acc; acc += freqs[syms[i]]; }
    }
    size_t base = out.size();
    out.resize(base + 256 * 4 + 8);
    uint8_t* cp = out.data() + base;
    cp = nx16_put_alphabet(cp, syms, count);
    for (int i = 0; i < count; ++i) cp = nx16_put_uint7(cp, freqs[syms[i]]);
    out.resize(cp - out.data());

    std::vector<Nx16Enc> states(n_states);
    std::vector<uint16_t> words;
    words.reserve(static_cast<size_t>(n) / 2 + 8);
    for (int64_t i = n - 1; i >= 0; --i) {
        int s = in[i];
        states[i % n_states].put(words, cum[s], static_cast<uint32_t>(freqs[s]), 12);
    }
    for (int j = 0; j < n_states; ++j) {
        uint32_t x = states[j].x;
        out.push_back(x & 0xFF); out.push_back((x >> 8) & 0xFF);
        out.push_back((x >> 16) & 0xFF); out.push_back((x >> 24) & 0xFF);
    }
    for (size_t i = words.size(); i > 0; --i) {
        out.push_back(words[i - 1] & 0xFF);
        out.push_back((words[i - 1] >> 8) & 0xFF);
    }
}

static bool nx16_o0_decode_body(const uint8_t*& cp, const uint8_t* end,
                                uint8_t* out, int64_t n, int n_states) {
    int syms[256], count = 0;
    cp = nx16_get_alphabet(cp, end, syms, &count);
    if (cp == nullptr) return false;
    int64_t freqs[256] = {0};
    for (int i = 0; i < count; ++i) {
        uint64_t v;
        cp = nx16_get_uint7(cp, end, &v);
        if (cp == nullptr) return false;
        freqs[syms[i]] = static_cast<int64_t>(v);
    }
    nx16_normalize(freqs, syms, count, NX16_TOT);
    std::vector<uint8_t> lookup(NX16_TOT);
    std::vector<uint32_t> lf(NX16_TOT), lc(NX16_TOT);
    {
        uint32_t acc = 0;
        for (int i = 0; i < count; ++i) {
            int s = syms[i];
            uint32_t f = static_cast<uint32_t>(freqs[s]);
            if (acc + f > NX16_TOT) return false;
            for (uint32_t k = 0; k < f; ++k) {
                lookup[acc + k] = static_cast<uint8_t>(s);
                lf[acc + k] = f;
                lc[acc + k] = acc;
            }
            acc += f;
        }
        if (acc != NX16_TOT) return false;
    }
    if (end - cp < 4 * n_states) return false;
    std::vector<Nx16Dec> states(n_states);
    for (int j = 0; j < n_states; ++j) states[j].init(cp);
    for (int64_t i = 0; i < n; ++i) {
        Nx16Dec& st = states[i % n_states];
        uint32_t slot = st.x & (NX16_TOT - 1);
        out[i] = lookup[slot];
        if (!st.advance(cp, end, lf[slot], slot, lc[slot], 12)) return false;
    }
    return true;
}

// order-1 body: mirrors rans_nx16._o1_encode exactly (leader-adjusted
// counts, used = rows|cols|{first}|{0}, per-row normalisation, optional
// order-0 compression of the serialized tables, fragment+tail states)
static void nx16_o1_body(const uint8_t* in, int64_t n, int n_states,
                         std::vector<uint8_t>& out) {
    int64_t frag = n / n_states;
    std::vector<int64_t> counts(256 * 256, 0);
    for (int64_t i = 1; i < n; ++i) counts[in[i - 1] * 256 + in[i]]++;
    if (n > 0) {
        if (frag > 0) {
            for (int j = 0; j < n_states; ++j) {
                int64_t start = j * frag;
                counts[0 * 256 + in[start]]++;
                if (start > 0) counts[in[start - 1] * 256 + in[start]]--;
            }
        } else {
            counts[0 * 256 + in[0]]++;
        }
    }
    bool used_mask[256] = {false};
    used_mask[0] = true;
    if (n > 0) used_mask[in[0]] = true;
    for (int i = 0; i < 256; ++i)
        for (int j = 0; j < 256; ++j)
            if (counts[i * 256 + j] > 0) { used_mask[i] = true; used_mask[j] = true; }
    int used[256], ucount = 0;
    for (int s = 0; s < 256; ++s)
        if (used_mask[s]) used[ucount++] = s;

    std::vector<int64_t> rows(256 * 256, 0);
    for (int ui = 0; ui < ucount; ++ui) {
        int i = used[ui];
        int syms[256], count = 0;
        for (int uj = 0; uj < ucount; ++uj) {
            int j = used[uj];
            if (counts[i * 256 + j] > 0) {
                rows[i * 256 + j] = counts[i * 256 + j];
                syms[count++] = j;
            }
        }
        if (count == 0) {
            rows[i * 256 + used[0]] = 1;
            syms[count++] = used[0];
        }
        nx16_normalize(&rows[i * 256], syms, count, NX16_TOT);
    }

    // serialized tables
    std::vector<uint8_t> table(256 * 4 + 2 + 256u * 256u * 3u);
    uint8_t* cp = table.data();
    cp = nx16_put_alphabet(cp, used, ucount);
    for (int ui = 0; ui < ucount; ++ui)
        for (int uj = 0; uj < ucount; ++uj)
            cp = nx16_put_uint7(cp, rows[used[ui] * 256 + used[uj]]);
    table.resize(cp - table.data());

    std::vector<uint8_t> packed;
    nx16_o0_body(table.data(), static_cast<int64_t>(table.size()), 4, packed);
    uint8_t lenbuf[10];
    size_t len7 = nx16_put_uint7(lenbuf, table.size()) - lenbuf;
    if (packed.size() + 2 + len7 < table.size()) {
        out.push_back((12 << 4) | 1);
        uint8_t tmp[10];
        out.insert(out.end(), tmp, nx16_put_uint7(tmp, packed.size()));
        out.insert(out.end(), tmp, nx16_put_uint7(tmp, table.size()));
        out.insert(out.end(), packed.begin(), packed.end());
    } else {
        out.push_back(12 << 4);
        out.insert(out.end(), table.begin(), table.end());
    }

    std::vector<uint32_t> cum(256 * 256, 0);
    for (int ui = 0; ui < ucount; ++ui) {
        int i = used[ui];
        uint32_t acc = 0;
        for (int uj = 0; uj < ucount; ++uj) {
            int j = used[uj];
            cum[i * 256 + j] = acc;
            acc += static_cast<uint32_t>(rows[i * 256 + j]);
        }
    }

    std::vector<Nx16Enc> states(n_states);
    std::vector<uint16_t> words;
    words.reserve(static_cast<size_t>(n) / 2 + 8);
    // tail rides the last state (encoded first)
    for (int64_t i = n - 1; i >= n_states * frag; --i) {
        int ctx = i > 0 ? in[i - 1] : 0;
        states[n_states - 1].put(
            words, cum[ctx * 256 + in[i]],
            static_cast<uint32_t>(rows[ctx * 256 + in[i]]), 12);
    }
    for (int64_t i = frag - 1; i >= 0; --i) {
        for (int j = n_states - 1; j >= 0; --j) {
            int64_t pos = j * frag + i;
            int ctx = i > 0 ? in[pos - 1] : 0;
            states[j].put(
                words, cum[ctx * 256 + in[pos]],
                static_cast<uint32_t>(rows[ctx * 256 + in[pos]]), 12);
        }
    }
    for (int j = 0; j < n_states; ++j) {
        uint32_t x = states[j].x;
        out.push_back(x & 0xFF); out.push_back((x >> 8) & 0xFF);
        out.push_back((x >> 16) & 0xFF); out.push_back((x >> 24) & 0xFF);
    }
    for (size_t i = words.size(); i > 0; --i) {
        out.push_back(words[i - 1] & 0xFF);
        out.push_back((words[i - 1] >> 8) & 0xFF);
    }
}

static bool nx16_o1_decode_body(const uint8_t*& cp, const uint8_t* end,
                                uint8_t* out, int64_t n, int n_states) {
    if (cp >= end) return false;
    uint8_t lead = *cp++;
    int shift = lead >> 4;
    if (shift != 10 && shift != 12) return false;
    uint32_t size = 1u << shift;
    std::vector<uint8_t> table_store;
    const uint8_t* tb;
    const uint8_t* tend;
    if (lead & 1) {
        uint64_t clen, tlen;
        cp = nx16_get_uint7(cp, end, &clen);
        if (cp == nullptr) return false;
        cp = nx16_get_uint7(cp, end, &tlen);
        if (cp == nullptr || tlen > (1u << 26)) return false;
        if (static_cast<uint64_t>(end - cp) < clen) return false;
        table_store.resize(tlen);
        const uint8_t* icp = cp;
        const uint8_t* iend = cp + clen;
        if (!nx16_o0_decode_body(icp, iend, table_store.data(),
                                 static_cast<int64_t>(tlen), 4))
            return false;
        cp += clen;
        tb = table_store.data();
        tend = tb + table_store.size();
    } else {
        tb = cp;
        tend = end;
    }
    int used[256], ucount = 0;
    tb = nx16_get_alphabet(tb, tend, used, &ucount);
    if (tb == nullptr) return false;
    std::vector<int64_t> rows(256 * 256, 0);
    for (int ui = 0; ui < ucount; ++ui) {
        int syms[256], count = 0;
        for (int uj = 0; uj < ucount; ++uj) {
            uint64_t v;
            tb = nx16_get_uint7(tb, tend, &v);
            if (tb == nullptr) return false;
            if (v) {
                rows[used[ui] * 256 + used[uj]] = static_cast<int64_t>(v);
                syms[count++] = used[uj];
            }
        }
        if (count)
            nx16_normalize(&rows[used[ui] * 256], syms, count, size);
    }
    if (!(lead & 1)) cp = tb;

    // dense per-context decode tables
    std::vector<uint8_t> lookup(256u * size, 0);
    std::vector<uint32_t> lf(256u * size, 1), lc(256u * size, 0);
    for (int ui = 0; ui < ucount; ++ui) {
        int i = used[ui];
        uint32_t acc = 0;
        for (int uj = 0; uj < ucount; ++uj) {
            int j = used[uj];
            uint32_t f = static_cast<uint32_t>(rows[i * 256 + j]);
            if (!f) continue;
            if (acc + f > size) return false;
            for (uint32_t k = 0; k < f; ++k) {
                lookup[i * size + acc + k] = static_cast<uint8_t>(j);
                lf[i * size + acc + k] = f;
                lc[i * size + acc + k] = acc;
            }
            acc += f;
        }
        if (acc != 0 && acc != size) return false;
    }

    if (end - cp < 4 * n_states) return false;
    std::vector<Nx16Dec> states(n_states);
    for (int j = 0; j < n_states; ++j) states[j].init(cp);
    int64_t frag = n / n_states;
    std::vector<int> ctx(n_states, 0);
    uint32_t mask = size - 1;
    for (int64_t i = 0; i < frag; ++i) {
        for (int j = 0; j < n_states; ++j) {
            Nx16Dec& st = states[j];
            uint32_t slot = st.x & mask;
            size_t at = static_cast<size_t>(ctx[j]) * size + slot;
            uint8_t sym = lookup[at];
            out[j * frag + i] = sym;
            if (!st.advance(cp, end, lf[at], slot, lc[at], shift))
                return false;
            ctx[j] = sym;
        }
    }
    {
        Nx16Dec& st = states[n_states - 1];
        int c = frag ? ctx[n_states - 1] : 0;
        for (int64_t i = n_states * frag; i < n; ++i) {
            uint32_t slot = st.x & mask;
            size_t at = static_cast<size_t>(c) * size + slot;
            uint8_t sym = lookup[at];
            out[i] = sym;
            if (!st.advance(cp, end, lf[at], slot, lc[at], shift))
                return false;
            c = sym;
        }
    }
    return true;
}

// flags: 0x01 order-1, 0x04 32-way; any other bit -> -3 (python handles)
int64_t pq_rans_nx16_compress(const uint8_t* in, int64_t in_size, int flags,
                              uint8_t* out, int64_t capacity) {
    if (flags & ~0x05) return -3;
    int n_states = (flags & 0x04) ? 32 : 4;
    std::vector<uint8_t> body;
    body.reserve(static_cast<size_t>(in_size) + 1024);
    if (flags & 0x01) nx16_o1_body(in, in_size, n_states, body);
    else nx16_o0_body(in, in_size, n_states, body);
    uint8_t head[12];
    head[0] = static_cast<uint8_t>(flags);
    size_t hlen = nx16_put_uint7(head + 1, in_size) - head;
    if (static_cast<int64_t>(hlen + body.size()) > capacity) return -1;
    memcpy(out, head, hlen);
    memcpy(out + hlen, body.data(), body.size());
    return static_cast<int64_t>(hlen + body.size());
}

// returns raw size written, -1 capacity, -2 corrupt, -3 unsupported flags
int64_t pq_rans_nx16_uncompress(const uint8_t* in, int64_t in_size,
                                uint8_t* out, int64_t capacity) {
    if (in_size < 1) return -2;
    int flags = in[0];
    if (flags & ~0x05) return -3;  // transforms / NOSZ: python path
    const uint8_t* cp = in + 1;
    const uint8_t* end = in + in_size;
    uint64_t n;
    cp = nx16_get_uint7(cp, end, &n);
    if (cp == nullptr) return -2;
    if (static_cast<int64_t>(n) > capacity) return -1;
    int n_states = (flags & 0x04) ? 32 : 4;
    bool ok = (flags & 0x01)
        ? nx16_o1_decode_body(cp, end, out, static_cast<int64_t>(n), n_states)
        : nx16_o0_decode_body(cp, end, out, static_cast<int64_t>(n), n_states);
    return ok ? static_cast<int64_t>(n) : -2;
}

}  // extern "C"

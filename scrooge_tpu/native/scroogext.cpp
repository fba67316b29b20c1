// CPython extension: zero-copy host prep + CIGAR-token post-processing.
//
// The ctypes library (cigar_strings.cpp) requires the caller to join all
// sequences into one contiguous ASCII buffer first — two full Python-side
// copies (str join + .encode) that dominate host prep at headline batch
// sizes on a single-core host. This module reads each sequence straight
// out of the CPython str object (PyUnicode 1-byte data, no copies) and
// encodes+packs with a SWAR/BMI2 inner loop (~10x the scalar LUT loop).
//
// It also decodes the device's compressed CIGAR *token* stream (see
// scrooge_tpu/ops/tokens.py for the format) into CIGAR strings / packed
// runs; tokens exist to shrink the device->host readback, and creating
// the result strings directly as
// PyUnicode objects here skips the bytes->slice->decode round trip the
// ctypes formatters need.
//
// Role in the reference: ascii_to_zero_based_string (genasm_cpu.cpp:462-493),
// the TwoBitArray packers (genasm_gpu.cu:640-685), and cigarlist_to_cigar
// (genasm_gpu.cu:881-888) — all host/device prep+post steps outside the
// timed kernel there as here.
//
// Built on demand with g++ (-march=native when available; scalar fallback
// otherwise) and loaded via importlib — no pybind11 in the image.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__BMI2__)
#include <immintrin.h>
#endif

namespace {

constexpr uint64_t M01 = 0x0101010101010101ULL;
constexpr uint64_t M80 = 0x8080808080808080ULL;
constexpr uint64_t M03 = 0x0303030303030303ULL;
constexpr uint64_t M20 = 0x2020202020202020ULL;

// per-byte equals-c detector: result has 0x80 set in every byte == c
static inline uint64_t eq_bytes(uint64_t x, uint8_t c) {
    uint64_t v = x ^ (M01 * c);
    return (v - M01) & ~v & M80;
}

// 8 ASCII bases -> 8 2-bit codes in the low bits of each byte.
// Mapping trick: (c >> 1) & 3 gives A->0 C->1 G->3 T->2 (case-insensitive
// since bit 5 never reaches bits [1:0] after >>1... it does: bit5>>1 =
// bit4; 'a'=0x61>>1=0x30 — bits [1:0] still 0). Swap 2<->3 with
// x ^= (x >> 1) & 1 per byte to get the canonical A0 C1 G2 T3.
static inline uint64_t codes8(uint64_t w) {
    uint64_t x = (w >> 1) & M03;
    return x ^ ((x >> 1) & M01);
}

// validity: every byte, lowercased, must be one of acgt
static inline bool valid8(uint64_t w) {
    uint64_t v = w | M20;
    uint64_t ok = eq_bytes(v, 'a') | eq_bytes(v, 'c') | eq_bytes(v, 'g') |
                  eq_bytes(v, 't');
    return ok == M80;
}

static inline uint16_t pack8(uint64_t codes) {
#if defined(__BMI2__)
    return (uint16_t)_pext_u64(codes, M03);
#else
    // multiply-gather: byte k's 2 bits land at [2k, 2k+2) of the top word
    // after multiplying by the magic stride (each byte spaced 8 bits,
    // target spacing 2 bits -> stride 2^(48 - 6k) summed)
    uint16_t out = 0;
    for (int k = 0; k < 8; k++)
        out |= (uint16_t)(((codes >> (8 * k)) & 3) << (2 * k));
    return out;
#endif
}

static const uint8_t* encode_lut() {
    static uint8_t lut[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; i++) lut[i] = 0xFF;
        lut['A'] = lut['a'] = 0;
        lut['C'] = lut['c'] = 1;
        lut['G'] = lut['g'] = 2;
        lut['T'] = lut['t'] = 3;
        init = true;
    }
    return lut;
}

// Fused encode+pack of one row: n ASCII bytes -> ceil(n/16) uint32 words
// (char k of a word at bits [2k, 2k+2)), tail of Pw words zero-filled.
// Returns -1 on success or the index of the first invalid byte.
static int64_t encode_pack_row(const uint8_t* src, int64_t n, uint32_t* dst,
                               int64_t Pw) {
    const uint8_t* lut = encode_lut();
    int64_t nw = (n + 15) / 16;
    if (nw > Pw) nw = Pw;
    int64_t w = 0;
    for (; w + 1 <= nw && (w + 1) * 16 <= n; w++) {
        uint64_t a, b;
        memcpy(&a, src + w * 16, 8);
        memcpy(&b, src + w * 16 + 8, 8);
        if (!(valid8(a) && valid8(b))) {
            for (int64_t k = w * 16; k < n; k++)
                if (lut[src[k]] == 0xFF) return k;
        }
        dst[w] = (uint32_t)pack8(codes8(a)) |
                 ((uint32_t)pack8(codes8(b)) << 16);
    }
    for (; w < nw; w++) {  // tail word, scalar
        uint32_t acc = 0;
        int64_t base = w * 16;
        int64_t hi = n - base < 16 ? n - base : 16;
        for (int64_t k = 0; k < hi; k++) {
            uint8_t code = lut[src[base + k]];
            if (code == 0xFF) return base + k;
            acc |= (uint32_t)code << (2 * k);
        }
        dst[w] = acc;
    }
    for (; w < Pw; w++) dst[w] = 0;
    return -1;
}

// Unpacked variant: n ASCII bytes -> P uint8 codes, zero-padded.
static int64_t encode_row(const uint8_t* src, int64_t n, uint8_t* dst,
                          int64_t P) {
    const uint8_t* lut = encode_lut();
    if (n > P) n = P;
    int64_t k = 0;
    for (; k + 8 <= n; k += 8) {
        uint64_t a;
        memcpy(&a, src + k, 8);
        if (!valid8(a)) break;  // locate exactly below
        uint64_t c = codes8(a);
        memcpy(dst + k, &c, 8);
    }
    for (; k < n; k++) {
        uint8_t code = lut[src[k]];
        if (code == 0xFF) return k;
        dst[k] = code;
    }
    memset(dst + n, 0, (size_t)(P - n));
    return -1;
}

struct RowView {
    const uint8_t* data;
    int64_t len;
};

// Collect 1-byte (ASCII/Latin-1) str buffers from a sequence of str.
// Returns 0 on success; on failure sets a Python error. Non-compact or
// wide strings raise ValueError (our sequences are ACGT by contract; a
// wide str necessarily contains non-ACGT codepoints).
static int collect_rows(PyObject* seqs, std::vector<RowView>& rows) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seqs);
    rows.resize((size_t)n);
    PyObject** items = PySequence_Fast_ITEMS(seqs);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject* s = items[i];
        if (!PyUnicode_Check(s)) {
            PyErr_SetString(PyExc_TypeError, "sequences must be str");
            return -1;
        }
        if (PyUnicode_KIND(s) != PyUnicode_1BYTE_KIND) {
            // a wide str necessarily holds non-ACGT codepoints; report the
            // FIRST invalid char (which may be an earlier ASCII one)
            const void* data = PyUnicode_DATA(s);
            int kind = PyUnicode_KIND(s);
            Py_ssize_t len = PyUnicode_GET_LENGTH(s);
            const uint8_t* lut = encode_lut();
            for (Py_ssize_t k = 0; k < len; k++) {
                Py_UCS4 ch = PyUnicode_READ(kind, data, k);
                if (ch >= 256 || lut[ch] == 0xFF) {
                    PyObject* c = PyUnicode_FromOrdinal(ch);
                    PyErr_Format(PyExc_ValueError,
                                 "non-ACGT character in sequence: %R", c);
                    Py_XDECREF(c);
                    return -1;
                }
            }
            PyErr_SetString(PyExc_ValueError,
                            "non-ACGT character in sequence");
            return -1;
        }
        rows[(size_t)i].data = PyUnicode_1BYTE_DATA(s);
        rows[(size_t)i].len = (int64_t)PyUnicode_GET_LENGTH(s);
    }
    return 0;
}

static void raise_bad_char(const RowView& row, int64_t pos) {
    uint8_t c = row.data[pos];
    PyObject* ch = PyUnicode_FromOrdinal(c);
    PyErr_Format(PyExc_ValueError, "non-ACGT character in sequence: %R", ch);
    Py_XDECREF(ch);
}

// encode_pack_into(seqs: Sequence[str], Pw: int, out_addr: int) -> None
// out: rows x Pw uint32 (caller-allocated). ValueError on non-ACGT.
static PyObject* encode_pack_into(PyObject*, PyObject* args) {
    PyObject* seqs_obj;
    Py_ssize_t Pw;
    unsigned long long out_addr;
    if (!PyArg_ParseTuple(args, "OnK", &seqs_obj, &Pw, &out_addr))
        return nullptr;
    PyObject* fast = PySequence_Fast(seqs_obj, "seqs must be a sequence");
    if (!fast) return nullptr;
    std::vector<RowView> rows;
    if (collect_rows(fast, rows) != 0) {
        Py_DECREF(fast);
        return nullptr;
    }
    uint32_t* out = (uint32_t*)(uintptr_t)out_addr;
    int64_t bad_row = -1, bad_pos = -1;
    Py_BEGIN_ALLOW_THREADS  // str buffers stay valid: `fast` holds refs
    for (size_t r = 0; r < rows.size(); r++) {
        int64_t bp = encode_pack_row(rows[r].data, rows[r].len,
                                     out + (int64_t)r * Pw, Pw);
        if (bp >= 0) {
            bad_row = (int64_t)r;
            bad_pos = bp;
            break;
        }
    }
    Py_END_ALLOW_THREADS
    if (bad_row >= 0) {
        raise_bad_char(rows[(size_t)bad_row], bad_pos);
        Py_DECREF(fast);
        return nullptr;
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

// encode_into(seqs: Sequence[str], P: int, out_addr: int) -> None
// out: rows x P uint8 codes (caller-allocated).
static PyObject* encode_into(PyObject*, PyObject* args) {
    PyObject* seqs_obj;
    Py_ssize_t P;
    unsigned long long out_addr;
    if (!PyArg_ParseTuple(args, "OnK", &seqs_obj, &P, &out_addr))
        return nullptr;
    PyObject* fast = PySequence_Fast(seqs_obj, "seqs must be a sequence");
    if (!fast) return nullptr;
    std::vector<RowView> rows;
    if (collect_rows(fast, rows) != 0) {
        Py_DECREF(fast);
        return nullptr;
    }
    uint8_t* out = (uint8_t*)(uintptr_t)out_addr;
    int64_t bad_row = -1, bad_pos = -1;
    Py_BEGIN_ALLOW_THREADS
    for (size_t r = 0; r < rows.size(); r++) {
        int64_t bp = encode_row(rows[r].data, rows[r].len,
                                out + (int64_t)r * P, P);
        if (bp >= 0) {
            bad_row = (int64_t)r;
            bad_pos = bp;
            break;
        }
    }
    Py_END_ALLOW_THREADS
    if (bad_row >= 0) {
        raise_bad_char(rows[(size_t)bad_row], bad_pos);
        Py_DECREF(fast);
        return nullptr;
    }
    Py_DECREF(fast);
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// CIGAR token stream decode (format defined in scrooge_tpu/ops/tokens.py):
// one uint8 per token, tag = tok >> 5, val = tok & 31:
//   tag 0: a bare '='-run of length val (1..31)
//   tag 1/2/3 (X/I/D): an edit of that op, preceded by an '='-run of
//          length val (0..31; 0 = no preceding '=' run)
//   tag 4: extend the immediately preceding edit run by val (1..31)
// Decoding reproduces the device engines' (unmerged-across-windows)
// run stream exactly; see tests/test_tokens.py.

static const char OPS[5] = {'=', 'X', 'I', 'D', '?'};

// shared per-lane walk: calls EMIT(op, count) for each decoded run.
// toks points at the lane's FIRST token; tokens are contiguous (the
// device emits the compacted stream lane-major, ops/tokens.py).
template <typename Emit>
static inline void decode_lane(const uint8_t* toks, int64_t capT,
                               int64_t t, Emit&& emit) {
    if (t > capT) t = capT;
    int pend_op = -1;
    uint32_t pend_cnt = 0;
    for (int64_t g = 0; g < t; g++) {
        uint8_t tok = toks[g];
        uint32_t tag = tok >> 5, val = tok & 31;
        if (tag == 4) {
            pend_cnt += val;
            continue;
        }
        if (pend_op >= 0) {
            emit(pend_op, pend_cnt);
            pend_op = -1;
        }
        if (tag == 0) {
            emit(0, val);
        } else {
            if (val) emit(0, val);
            pend_op = (int)tag;
            pend_cnt = 1;
        }
    }
    if (pend_op >= 0) emit(pend_op, pend_cnt);
}

// format_tokens(tok_addr, capT, B, totals_addr) -> list[str]
// tokens: (B, capT) uint8 LANE-MAJOR; totals: (B,) int32.
static PyObject* format_tokens(PyObject*, PyObject* args) {
    unsigned long long tok_addr, totals_addr;
    Py_ssize_t capT, B;
    if (!PyArg_ParseTuple(args, "KnnK", &tok_addr, &capT, &B, &totals_addr))
        return nullptr;
    const uint8_t* toks = (const uint8_t*)(uintptr_t)tok_addr;
    const int32_t* totals = (const int32_t*)(uintptr_t)totals_addr;
    PyObject* out = PyList_New(B);
    if (!out) return nullptr;
    std::vector<char> buf;
    for (Py_ssize_t b = 0; b < B; b++) {
        buf.clear();
        decode_lane(toks + b * capT, capT, totals[b],
                    [&](int op, uint32_t cnt) {
            char digits[8];
            int nd = 0;
            if (cnt == 0) digits[nd++] = '0';
            while (cnt > 0) {
                digits[nd++] = (char)('0' + cnt % 10);
                cnt /= 10;
            }
            while (nd > 0) buf.push_back(digits[--nd]);
            buf.push_back(OPS[op]);
        });
        PyObject* s = PyUnicode_FromStringAndSize(buf.data(),
                                                  (Py_ssize_t)buf.size());
        if (!s) {
            Py_DECREF(out);
            return nullptr;
        }
        PyList_SET_ITEM(out, b, s);
    }
    return out;
}

// tokens_to_runs(tok_addr, capT, B, totals_addr, out_addr, counts_addr)
//   -> total_runs
// tokens: (B, capT) uint8 LANE-MAJOR. Decodes the token stream to packed
// uint16 runs (op << 12 | count), lane-contiguous in lane order. out must
// hold >= 2 * sum(totals) entries (each token expands to at most 2 runs);
// counts: (B,) int64 runs/lane.
static PyObject* tokens_to_runs(PyObject*, PyObject* args) {
    unsigned long long tok_addr, totals_addr, out_addr, counts_addr;
    Py_ssize_t capT, B;
    if (!PyArg_ParseTuple(args, "KnnKKK", &tok_addr, &capT, &B, &totals_addr,
                          &out_addr, &counts_addr))
        return nullptr;
    const uint8_t* toks = (const uint8_t*)(uintptr_t)tok_addr;
    const int32_t* totals = (const int32_t*)(uintptr_t)totals_addr;
    uint16_t* out = (uint16_t*)(uintptr_t)out_addr;
    int64_t* counts = (int64_t*)(uintptr_t)counts_addr;
    int64_t pos = 0;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t b = 0; b < B; b++) {
        int64_t start = pos;
        decode_lane(toks + b * capT, capT, totals[b],
                    [&](int op, uint32_t cnt) {
            out[pos++] = (uint16_t)(((uint32_t)op << 12) | (cnt & 0x0FFF));
        });
        counts[b] = pos - start;
    }
    Py_END_ALLOW_THREADS
    return PyLong_FromLongLong((long long)pos);
}

// scatter_runs(flat_addr, offs_addr, idx_addr, n, lens_addr, out_addr,
//              out_offs_addr) -> None
// Permutation copy for assembling PackedAlignments across tiles/retries:
// source pair k (k = 0..n-1) holds lens[k] uint16 runs at
// flat[offs[k]:offs[k]+lens[k]] and lands at out[out_offs[idx[k]]].
static PyObject* scatter_runs(PyObject*, PyObject* args) {
    unsigned long long flat_addr, offs_addr, idx_addr, lens_addr, out_addr,
        out_offs_addr;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "KKKnKKK", &flat_addr, &offs_addr, &idx_addr,
                          &n, &lens_addr, &out_addr, &out_offs_addr))
        return nullptr;
    const uint16_t* flat = (const uint16_t*)(uintptr_t)flat_addr;
    const int64_t* offs = (const int64_t*)(uintptr_t)offs_addr;
    const int64_t* idx = (const int64_t*)(uintptr_t)idx_addr;
    const int64_t* lens = (const int64_t*)(uintptr_t)lens_addr;
    uint16_t* out = (uint16_t*)(uintptr_t)out_addr;
    const int64_t* out_offs = (const int64_t*)(uintptr_t)out_offs_addr;
    Py_BEGIN_ALLOW_THREADS
    for (Py_ssize_t k = 0; k < n; k++)
        memcpy(out + out_offs[idx[k]], flat + offs[k],
               (size_t)lens[k] * sizeof(uint16_t));
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyMethodDef Methods[] = {
    {"encode_pack_into", encode_pack_into, METH_VARARGS,
     "Fused ASCII->2bit->uint32-word rows straight from str objects."},
    {"encode_into", encode_into, METH_VARARGS,
     "ASCII->2bit uint8 code rows straight from str objects."},
    {"format_tokens", format_tokens, METH_VARARGS,
     "CIGAR token stream (capT, B) -> list of CIGAR strings."},
    {"tokens_to_runs", tokens_to_runs, METH_VARARGS,
     "CIGAR token stream -> flat packed uint16 runs + per-lane counts."},
    {"scatter_runs", scatter_runs, METH_VARARGS,
     "Permutation-copy packed runs into their final pair order."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef Module = {PyModuleDef_HEAD_INIT, "_scroogext",
                                    "scrooge_tpu native host runtime",
                                    -1, Methods};

}  // namespace

PyMODINIT_FUNC PyInit__scroogext(void) { return PyModule_Create(&Module); }

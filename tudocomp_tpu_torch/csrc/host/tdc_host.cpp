// tdc_host: the port's C++ host helpers, loaded with ctypes by
// tudocomp_tpu_torch/native.py (built with g++ at first use).
//
// A copy of the host entry points of native/tdc_native.cpp that the port's
// host layers call, with what they depend on:
//   - the LZ78 parse (open-addressing hash trie) and decode;
//   - the LZW parse (the same trie) and decode;
//   - the token pack and read of the bit writer and reader;
//   - the canonical Huffman bulk decodes (table and first-code forms);
//   - the segmented token interleave of coders/base.py;
//   - the suffix stack of lzss_lcp: SA-IS, the phi-algorithm PLCP, the
//     inverse permutation, phi and gather helpers, the SparseISA shortcut
//     build, the monotone-stack LZSS factorizer, and the lzss stream parse
//     and factor copy of the decoder;
//   - ESP: one round of the host grammar (tdc_esp_round), the SLP's
//     expansion (tdc_esp_derive), the canonical index decode of the
//     huffman d_coding, and the longest increasing subsequence of the
//     optimal subseq strategy (tdc_lis_indices, the port's own);
//   - the arithmetic coder's encode and decode loops;
//   - lcpcomp: the six factorization strategies (arrays, heap, bheap,
//     plcp, max_lcp, plcppeaks; the heap strategies share SlottedMaxHeap),
//     the factor flatten, and the four decoders (scan, compact, queue
//     list, multimap);
//   - the transforms: the RLE decode, the MTF encode and decode, and the
//     BWT's LF walk;
//   - the sliding-window lzss parse and Re-Pair's grammar build and
//     expansion.
// Every entry point returns what the JAX package's copy returns on the same
// input, so the port's host path writes the same bytes. The JAX package's
// other trie backends are left out: every trie gives the same factors, so
// the port routes every lz78trie choice to the one hash trie here.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared -o libtdc_host.so tdc_host.cpp

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

// Open-addressing hash map from packed (parent << 8 | char) to node id.
struct HashTrie {
    std::vector<uint64_t> keys;   // packed key + 1 (0 = empty)
    std::vector<uint32_t> vals;
    uint64_t mask;
    size_t size_ = 0;

    explicit HashTrie(size_t expected) {
        size_t cap = 16;
        while (cap < expected * 2) cap <<= 1;
        keys.assign(cap, 0);
        vals.assign(cap, 0);
        mask = cap - 1;
    }

    static inline uint64_t mix(uint64_t x) {
        // splitmix64 finalizer
        x += 0x9e3779b97f4a7c15ULL;
        x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
        x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
        return x ^ (x >> 31);
    }

    void grow() {
        std::vector<uint64_t> old_keys = std::move(keys);
        std::vector<uint32_t> old_vals = std::move(vals);
        size_t cap = (mask + 1) << 1;
        keys.assign(cap, 0);
        vals.assign(cap, 0);
        mask = cap - 1;
        for (size_t i = 0; i <= (old_keys.size() - 1); ++i) {
            if (old_keys[i]) {
                uint64_t slot = mix(old_keys[i] - 1) & mask;
                while (keys[slot]) slot = (slot + 1) & mask;
                keys[slot] = old_keys[i];
                vals[slot] = old_vals[i];
            }
        }
    }

    // returns existing id or inserts new_id and returns UINT32_MAX
    inline uint32_t find_or_insert(uint64_t key, uint32_t new_id) {
        uint64_t k1 = key + 1;
        uint64_t slot = mix(key) & mask;
        while (true) {
            if (!keys[slot]) {
                keys[slot] = k1;
                vals[slot] = new_id;
                if (++size_ * 2 > mask) grow();
                return UINT32_MAX;
            }
            if (keys[slot] == k1) return vals[slot];
            slot = (slot + 1) & mask;
        }
    }
};

}  // namespace

extern "C" {

// LZ78 parse (semantics of LZ78Compressor::compress,
// compressors/LZ78Compressor.hpp:64-131): factor i emits
// (parent_id in [0, i], literal); node ids: root = 0, factor i creates node
// i+1; a trailing partial factor re-emits (parent(node), last char)
// (LZ78Compressor.hpp:124-131). Records per-node (parent, char) for that.
// Returns the number of factors (buffers must hold n entries).
int64_t tdc_lz78_parse(const uint8_t* data, int64_t n, uint32_t* parents,
                        uint8_t* chars) {
    HashTrie trie((size_t)n + 1);
    std::vector<uint32_t> node_parent(1, 0);
    std::vector<uint8_t> node_char(1, 0);
    int64_t nf = 0;
    uint32_t node = 0;
    uint32_t next_id = 1;
    int64_t i = 0;
    while (i < n) {
        uint8_t c = data[i++];
        uint64_t key = ((uint64_t)node << 8) | c;
        uint32_t found = trie.find_or_insert(key, next_id);
        if (found == UINT32_MAX) {
            parents[nf] = node;
            chars[nf] = c;
            ++nf;
            node_parent.push_back(node);
            node_char.push_back(c);
            ++next_id;
            node = 0;
        } else {
            node = found;
        }
    }
    if (node != 0) {
        parents[nf] = node_parent[node];
        chars[nf] = node_char[node];
        ++nf;
    }
    return nf;
}

// LZ78 decode (semantics of LZ78Compressor.hpp:16-38): factor (index, lit)
// expands to string(index) + lit. out must hold the total decoded length;
// pass out_cap for safety. Returns total length or -1 on overflow.
int64_t tdc_lz78_decode(const uint32_t* parents, const uint8_t* chars,
                        int64_t nf, uint8_t* out, int64_t out_cap) {
    std::vector<int64_t> flen((size_t)nf + 1, 0);  // length of string(node id)
    int64_t pos = 0;
    for (int64_t f = 0; f < nf; ++f) {
        uint32_t idx = parents[f];
        int64_t len = flen[idx] + 1;
        flen[f + 1] = len;
        if (pos + len > out_cap) return -1;
        // fill backwards
        int64_t p = pos + len - 1;
        out[p--] = chars[f];
        uint32_t k = idx;
        while (k != 0) {
            out[p--] = chars[k - 1];
            k = parents[k - 1];
        }
        pos += len;
    }
    return pos;
}

// LZW parse (semantics of LZWCompressor.hpp:38-105): dict pre-seeded with
// 256 root nodes (ids 0..255); factor i emits node_id in
// [0, i+256]; new node id = 256 + i. Returns factor count (buffer: n).
int64_t tdc_lzw_parse(const uint8_t* data, int64_t n, uint32_t* codes) {
    if (n == 0) return 0;
    HashTrie trie((size_t)n + 256);
    int64_t nf = 0;
    int64_t i = 0;
    uint32_t node = data[i++];
    uint32_t next_id = 256;
    while (i < n) {
        uint8_t c = data[i++];
        uint64_t key = ((uint64_t)node << 8) | c;
        uint32_t found = trie.find_or_insert(key, next_id);
        if (found == UINT32_MAX) {
            codes[nf++] = node;
            ++next_id;
            node = c;
        } else {
            node = found;
        }
    }
    codes[nf++] = node;  // final factor always emitted (LZWCompressor.hpp:99)
    return nf;
}

// LZW decode (semantics of lzw/LZWDecoding.hpp:13-99, including the
// k == dict.size() self-reference case). Returns decoded length, -1 on
// overflow, -2 on invalid code.
int64_t tdc_lzw_decode(const uint32_t* codes, int64_t nf, uint8_t* out,
                       int64_t out_cap) {
    // dictionary entries beyond the 256 roots: (prev_code, first_char,
    // length, out_offset) — storing the output offset lets us expand
    // entries with memcpy instead of chain walking.
    std::vector<uint32_t> prev;
    std::vector<int64_t> entry_off;  // offset of the expansion in out
    std::vector<int64_t> entry_len;
    prev.reserve((size_t)nf);
    entry_off.reserve((size_t)nf);
    entry_len.reserve((size_t)nf);

    int64_t pos = 0;
    uint32_t i_prev = UINT32_MAX;  // previous code (dms sentinel)
    for (int64_t f = 0; f < nf; ++f) {
        uint32_t k = codes[f];
        uint32_t dict_size = 256 + (uint32_t)prev.size();
        if (k > dict_size) return -2;
        int64_t start, len;
        if (k == dict_size) {
            // self-referential: new entry = string(i_prev) + first char of
            // string(i_prev)
            if (i_prev == UINT32_MAX) return -2;
            int64_t ps, pl;
            if (i_prev < 256) {
                ps = -1;
                pl = 1;
            } else {
                ps = entry_off[i_prev - 256];
                pl = entry_len[i_prev - 256];
            }
            len = pl + 1;
            if (pos + len > out_cap) return -1;
            if (ps < 0) {
                out[pos] = (uint8_t)i_prev;
            } else {
                std::memcpy(out + pos, out + ps, (size_t)pl);
            }
            out[pos + pl] = (ps < 0) ? (uint8_t)i_prev : out[ps];
            prev.push_back(i_prev);
            entry_off.push_back(pos);
            entry_len.push_back(len);
            start = pos;
            pos += len;
        } else {
            if (k < 256) {
                if (pos + 1 > out_cap) return -1;
                out[pos] = (uint8_t)k;
                start = pos;
                len = 1;
                pos += 1;
            } else {
                start = entry_off[k - 256];
                len = entry_len[k - 256];
                if (pos + len > out_cap) return -1;
                std::memcpy(out + pos, out + start, (size_t)len);
                start = pos;
                pos += len;
            }
            if (i_prev != UINT32_MAX) {
                // new entry = string(i_prev) + first char of string(k)
                int64_t pl = (i_prev < 256) ? 1 : entry_len[i_prev - 256];
                prev.push_back(i_prev);
                // expansion of the new entry is not materialized yet; record
                // its future location: it equals string(i_prev)+out[start],
                // which will be materialized when first referenced via the
                // k == dict_size case or a later copy. To keep offsets valid
                // we materialize lazily: store offset of i_prev's expansion
                // and synthesize on demand. Simpler: materialize now into a
                // scratch area is wasteful; instead store (off,len) pointing
                // at the *next* occurrence: string(i_prev) is at the output
                // location where it was just written previously... but that
                // may be stale. We instead note that string(i_prev) + c
                // always appears in the output ending at position start+1:
                // the previous factor wrote string(i_prev) ending at `start`,
                // and out[start] is c. So the entry's expansion is the
                // contiguous range [start - pl, start + 1).
                entry_off.push_back(start - pl);
                entry_len.push_back(pl + 1);
            }
        }
        i_prev = k;
    }
    return pos;
}


// Append (value, nbits) tokens MSB-first into a byte buffer starting at
// bit offset start_bit (buffer must be zeroed). Values must be pre-masked
// to their widths. Returns the new bit position. This is the host-side
// pack twin of ops/bitpack.py (device) and the hot path of BitWriter.
int64_t tdc_pack_tokens(const uint64_t* vals, const int64_t* nbits, int64_t n,
                        uint8_t* out, int64_t start_bit) {
    int64_t pos = start_bit;
    for (int64_t i = 0; i < n; ++i) {
        int w = (int)nbits[i];
        uint64_t v = vals[i];
        while (w > 0) {
            int free_bits = 8 - (int)(pos & 7);
            int take = free_bits < w ? free_bits : w;
            uint8_t chunk = (uint8_t)((v >> (w - take)) & ((1u << take) - 1));
            out[pos >> 3] |= (uint8_t)(chunk << (free_bits - take));
            pos += take;
            w -= take;
        }
    }
    return pos;
}

// Read n MSB-first tokens of the given widths from a byte buffer starting
// at bit offset start_bit. Returns the new bit position. Reverse twin of
// tdc_pack_tokens; the host-side batch path of BitReader.
int64_t tdc_read_tokens(const uint8_t* data, int64_t nbytes, int64_t start_bit,
                        const int64_t* nbits, int64_t n, uint64_t* out) {
    int64_t pos = start_bit;
    const int64_t total_bits = nbytes * 8;
    for (int64_t i = 0; i < n; ++i) {
        int w = (int)nbits[i];
        uint64_t v = 0;
        while (w > 0) {
            int avail = 8 - (int)(pos & 7);
            int take = avail < w ? avail : w;
            uint8_t byte = (pos >> 3) < nbytes ? data[pos >> 3] : 0;
            uint8_t chunk = (uint8_t)((byte >> (avail - take)) & ((1u << take) - 1));
            v = (v << take) | chunk;
            pos += take;
            w -= take;
        }
        // bits past the buffer read as 0 (BitIStream EOF semantics handled
        // by the caller via valid-bit accounting)
        (void)total_bits;
        out[i] = v;
    }
    return pos;
}

// Canonical Huffman decode without a LUT (for long codes): per symbol,
// extend the codeword bit by bit until value >= firstcode[length-1]
// (HuffmanCoder.hpp:584-609 decode semantics). firstcodes/psl indexed by
// length-1, sized `longest`. Returns symbol count.
int64_t tdc_huffman_decode_canonical(const uint8_t* data, int64_t start_bit,
                                     int64_t valid_bits,
                                     const uint64_t* firstcodes,
                                     const int64_t* psl,
                                     const uint8_t* ordered_syms,
                                     int32_t longest, uint8_t* out,
                                     int64_t max_symbols) {
    int64_t pos = start_bit;
    int64_t count = 0;
    while (count < max_symbols && pos < valid_bits) {
        uint64_t value = 0;
        int len = 0;
        while (len < longest) {
            int bit = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
            ++pos;
            value = (value << 1) | (uint64_t)bit;
            ++len;
            if (value >= firstcodes[len - 1]) break;
        }
        out[count++] =
            ordered_syms[psl[len - 1] + (int64_t)(value - firstcodes[len - 1])];
    }
    return count;
}

// Canonical Huffman bulk decode over an MSB-first bitstream.
// lut_sym/lut_len: 2^longest-entry flat decode table; returns symbol count.
int64_t tdc_huffman_decode(const uint8_t* data, int64_t start_bit,
                           int64_t valid_bits, const uint8_t* lut_sym,
                           const uint8_t* lut_len, int32_t longest,
                           uint8_t* out, int64_t max_symbols) {
    int64_t pos = start_bit;
    int64_t count = 0;
    uint64_t acc = 0;
    int acc_n = 0;
    int64_t byte_i = pos >> 3;
    int bit_off = (int)(pos & 7);
    // preload partial byte
    if (bit_off) {
        acc = data[byte_i] & ((1u << (8 - bit_off)) - 1);
        acc_n = 8 - bit_off;
        ++byte_i;
    }
    const uint64_t kmask = ((uint64_t)1 << longest) - 1;
    while (count < max_symbols && pos < valid_bits) {
        while (acc_n < longest) {
            uint8_t b = (byte_i * 8 < valid_bits + 16) ? data[byte_i] : 0;
            // note: reading a byte past valid_bits is fine, bits are masked
            acc = (acc << 8) | b;
            acc_n += 8;
            ++byte_i;
        }
        uint64_t key = (acc >> (acc_n - longest)) & kmask;
        int l = lut_len[key];
        out[count++] = lut_sym[key];
        acc_n -= l;
        pos += l;
    }
    return count;
}

// Segmented token interleave (host twin of coders/base.py:write_segmented,
// the vectorized form of the reference's per-factor interleaved encode
// loops, e.g. lzss::encode_text LZSSCoding.hpp:19-92): segment s emits
// sc[c][s] values of column c in column order; a value expands to
// cnt[c][v] tokens. Columns arrive concatenated with offset tables.
// out_vals/out_bits must hold the total token count. Returns tokens
// written, or -1 if cursors overran (inconsistent metadata).
int64_t tdc_segment_interleave(const uint64_t* vals, const int64_t* bits,
                               const int64_t* col_tok_off,
                               const int64_t* cnt, const int64_t* col_val_off,
                               const int64_t* sc, int64_t C, int64_t S,
                               uint64_t* out_vals, int64_t* out_bits) {
    std::vector<int64_t> vi((size_t)C, 0), ti((size_t)C, 0);
    int64_t o = 0;
    for (int64_t s = 0; s < S; ++s) {
        for (int64_t c = 0; c < C; ++c) {
            const int64_t nvals = sc[c * S + s];
            for (int64_t k = 0; k < nvals; ++k) {
                if (col_val_off[c] + vi[c] >= col_val_off[c + 1]) return -1;
                const int64_t nt = cnt[col_val_off[c] + vi[c]++];
                const int64_t src = col_tok_off[c] + ti[c];
                if (src + nt > col_tok_off[c + 1]) return -1;
                for (int64_t t = 0; t < nt; ++t) {
                    const int64_t b = bits[src + t];
                    const uint64_t m =
                        b >= 64 ? ~0ULL : ((1ULL << b) - 1);  // pre-mask
                    out_vals[o] = vals[src + t] & m;
                    out_bits[o] = b;
                    ++o;
                }
                ti[c] += nt;
            }
        }
    }
    return o;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Suffix array via SA-IS (Nong/Zhang/Chan 2009, induced sorting), written
// from scratch. Replaces the reference's vendored divsufsort
// (util/divsufsort.hpp) as the host-side SA constructor; same output
// contract (end-of-string sorts before every character).

namespace {

// s: values in [0, K), s[n-1] must be the unique smallest value.
// sa: output buffer of length n.
// Templated on the character type so the top level runs directly on the
// u8 text (4x less read traffic than widening to int32) ; the per-level
// histogram is counted ONCE and bucket cursors are re-derived from it
// (the original recounted the full histogram on every induce pass — four
// O(n) counting sweeps per level).
template <typename CharT>
void sais_rec(CharT* s, int32_t* sa, int64_t n, int64_t K) {
    if (n == 1) {
        sa[0] = 0;
        return;
    }
    // the S/L type bit rides the spare top bit of each character, so the
    // induce loops pay ONE random read (s[j]) instead of two (s[j]+t[j]);
    // alphabet values stay well below the bit (<= 257 at the top level,
    // < n/2 < 2^30 in recursions)
    constexpr CharT TBIT = (CharT)((CharT)1 << (sizeof(CharT) * 8 - 2));
    constexpr CharT CMASK = (CharT)(TBIT - 1);
    std::vector<uint8_t> t((size_t)n);
    t[n - 1] = 1;
    for (int64_t i = n - 2; i >= 0; --i)
        t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);
    auto isLMS = [&](int64_t i) { return i > 0 && t[i] && !t[i - 1]; };

    std::vector<int64_t> cnt((size_t)K + 1, 0);
    for (int64_t i = 0; i < n; ++i) cnt[s[i]]++;
    for (int64_t i = 0; i < n; ++i)
        if (t[i]) s[i] |= TBIT;
    std::vector<int64_t> bkt((size_t)K + 1);
    auto getBuckets = [&](bool end) {
        int64_t sum = 0;
        for (int64_t k = 0; k <= K; ++k) {
            sum += cnt[k];
            bkt[k] = end ? sum : sum - cnt[k];
        }
    };
    auto induceL = [&]() {
        getBuckets(false);
        for (int64_t i = 0; i < n; ++i) {
            int32_t pf = sa[i + 16 < n ? i + 16 : n - 1];
            if (pf > 0) __builtin_prefetch(&s[pf - 1]);
            int32_t sv = sa[i];
            if (sv > 0) {
                CharT v = s[sv - 1];
                if (!(v & TBIT)) sa[bkt[v]++] = sv - 1;
            }
        }
    };
    auto induceS = [&]() {
        getBuckets(true);
        for (int64_t i = n - 1; i >= 0; --i) {
            int32_t pf = sa[i - 16 >= 0 ? i - 16 : 0];
            if (pf > 0) __builtin_prefetch(&s[pf - 1]);
            int32_t sv = sa[i];
            if (sv > 0) {
                CharT v = s[sv - 1];
                if (v & TBIT) sa[--bkt[v & CMASK]] = sv - 1;
            }
        }
    };

    // stage 1: sort LMS substrings by induced sorting
    getBuckets(true);
    std::fill(sa, sa + n, -1);
    for (int64_t i = 1; i < n; ++i)
        if (isLMS(i)) sa[--bkt[s[i] & CMASK]] = (int32_t)i;
    induceL();
    induceS();

    // compact sorted LMS positions
    int64_t n1 = 0;
    for (int64_t i = 0; i < n; ++i)
        if (sa[i] > 0 && isLMS(sa[i])) sa[n1++] = sa[i];

    // name LMS substrings in sa[n1..n)
    std::fill(sa + n1, sa + n, -1);
    int64_t name = 0, prev = -1;
    for (int64_t i = 0; i < n1; ++i) {
        int64_t pos = sa[i];
        bool diff = false;
        if (prev < 0) {
            diff = true;
        } else {
            for (int64_t d = 0;; ++d) {
                // packed chars carry the type bit: one compare covers
                // both the character and the S/L type
                if (pos + d >= n || prev + d >= n ||
                    s[pos + d] != s[prev + d]) {
                    diff = true;
                    break;
                }
                if (d > 0 && (isLMS(pos + d) || isLMS(prev + d))) break;
            }
        }
        if (diff) {
            ++name;
            prev = pos;
        }
        sa[n1 + pos / 2] = (int32_t)(name - 1);
    }
    for (int64_t i = n - 1, j = n - 1; i >= n1; --i)
        if (sa[i] >= 0) sa[j--] = sa[i];

    // stage 2: recurse if names are not yet unique
    int32_t* s1 = sa + n - n1;
    if (name < n1) {
        sais_rec(s1, sa, n1, name);
    } else {
        for (int64_t i = 0; i < n1; ++i) sa[s1[i]] = (int32_t)i;
    }

    // stage 3: induce the full SA from the sorted LMS suffixes
    for (int64_t i = 1, j = 0; i < n; ++i)
        if (isLMS(i)) s1[j++] = (int32_t)i;  // s1 now maps rank index -> pos
    for (int64_t i = 0; i < n1; ++i) sa[i] = s1[sa[i]];
    std::fill(sa + n1, sa + n, -1);
    getBuckets(true);
    for (int64_t i = n1 - 1; i >= 0; --i) {
        int64_t j = sa[i];
        sa[i] = -1;
        sa[--bkt[s[j] & CMASK]] = (int32_t)j;
    }
    induceL();
    induceS();
}


}  // namespace

extern "C" {

// Suffix array of `text` with end-of-string < every byte (the divsufsort /
// prefix-doubling contract). Returns 0 on success.
int32_t tdc_sais(const uint8_t* text, int64_t n, int32_t* sa_out) {
    if (n <= 0) return 0;
    if (n == 1) {
        sa_out[0] = 0;
        return 0;
    }
    // shift alphabet by +1 and append a unique 0 sentinel; u16 keeps the
    // top-level induce sweeps at half the read traffic of an i32 copy
    std::vector<uint16_t> s((size_t)n + 1);
    for (int64_t i = 0; i < n; ++i) s[i] = (uint16_t)(text[i] + 1);
    s[n] = 0;
    std::vector<int32_t> sa((size_t)n + 1);
    sais_rec(s.data(), sa.data(), n + 1, 257);
    std::memcpy(sa_out, sa.data() + 1, (size_t)n * sizeof(int32_t));
    return 0;
}

}  // extern "C"

extern "C" {

// lzss_lcp factorization (exact semantics of LZSSLCPCompressor::compress,
// LZSSLCPCompressor.hpp:42-115): greedy left-to-right; at text position i
// the candidate is the longer of the PSV/NSV matches in SA order, ties
// prefer PSV. PSV/NSV positions with their min-LCP values are precomputed
// by monotone-stack passes (replacing the reference's naive per-position
// scans with an O(n) ANSV pass — SURVEY.md §7 step 6).
// Buffers fpos/fsrc/flen must hold n entries. Returns factor count.
int64_t tdc_lzss_lcp_factorize(const int32_t* sa, const int32_t* isa,
                               const int32_t* lcp, int64_t n,
                               int64_t threshold, uint32_t* fpos,
                               uint32_t* fsrc, uint32_t* flen) {
    if (n == 0) return 0;
    // psv_lcp[j] = min lcp over (psv_j, j] where psv_j = nearest j' < j with
    // sa[j'] < sa[j]; psv_src[j] = sa[psv_j]. Stack entries carry the min
    // lcp of their segment (between the entry below and themselves).
    // The four candidate values of SA position j live INTERLEAVED in one
    // 16-byte group (cand[4j..4j+3] = psv_lcp, nsv_lcp, psv_src,
    // nsv_src): the greedy walk below reads all four per visited
    // position, so one cache line serves what four separate arrays
    // answered with four misses.
    std::vector<int32_t> cand((size_t)n * 4);
    {
        std::vector<int32_t> st_idx;
        std::vector<int32_t> st_min;
        for (int64_t j = 0; j < n; ++j) {
            int32_t m = lcp[j];
            while (!st_idx.empty() && sa[st_idx.back()] > sa[j]) {
                m = std::min(m, st_min.back());
                st_idx.pop_back();
                st_min.pop_back();
            }
            if (st_idx.empty()) {
                cand[4 * j] = 0;
                cand[4 * j + 2] = -1;
            } else {
                cand[4 * j] = m;
                cand[4 * j + 2] = sa[st_idx.back()];
            }
            st_idx.push_back((int32_t)j);
            st_min.push_back(m);
        }
    }
    {
        std::vector<int32_t> st_idx;
        std::vector<int32_t> st_min;
        for (int64_t j = n - 1; j >= 0; --j) {
            int32_t m = j + 1 < n ? lcp[j + 1] : 0;
            // min lcp over (j, nsv] accumulates while popping
            int32_t run = 0x7FFFFFFF;
            while (!st_idx.empty() && sa[st_idx.back()] > sa[j]) {
                run = std::min(run, st_min.back());
                st_idx.pop_back();
                st_min.pop_back();
            }
            if (st_idx.empty()) {
                cand[4 * j + 1] = 0;
                cand[4 * j + 3] = -1;
            } else {
                cand[4 * j + 1] = std::min(m, run);
                cand[4 * j + 3] = sa[st_idx.back()];
            }
            // this entry's segment min: lcp between j and the element above
            st_idx.push_back((int32_t)j);
            st_min.push_back(std::min(m, run));
        }
    }
    // Greedy walk over VISITED positions only. (A text-order gather pass
    // for all n positions was tried and reverted: the walk visits only
    // ~20-40% of positions on repetitive inputs, so precomputing every
    // candidate tripled the random-read volume and the stage wall time.)
    // Speculative prefetch of the literal-successor candidate hides part
    // of the remaining two misses per step.
    int64_t nf = 0;
    for (int64_t i = 0; i + 1 < n;) {
        int32_t j = isa[i];
        if (i + 2 < n) {
            __builtin_prefetch(&isa[i + 1]);
            __builtin_prefetch(&cand[4 * (size_t)isa[i + 1]]);
        }
        const int32_t* c = &cand[4 * (size_t)j];
        int32_t pl = c[0], nl = c[1];
        int32_t maxl = pl >= nl ? pl : nl;  // ties prefer PSV (reference)
        if (maxl >= threshold) {
            fpos[nf] = (uint32_t)i;
            fsrc[nf] = (uint32_t)(pl >= nl ? c[2] : c[3]);
            flen[nf] = (uint32_t)maxl;
            ++nf;
            i += maxl;
        } else {
            ++i;
        }
    }
    return nf;
}

// SparseISA shortcut construction (ds/SparseISA.hpp cycle decomposition):
// walks every cycle of the SA permutation, marks each t-th element and
// stores its t-steps-back cycle predecessor. has[i] in {0,1}; val[i] is
// meaningful only where has[i] = 1.
void tdc_sparse_isa_build(const int64_t* sa, int64_t n, int64_t t,
                          uint8_t* has, int64_t* val) {
    std::vector<uint8_t> visited((size_t)n, 0);
    std::memset(has, 0, (size_t)n);
    std::vector<int64_t> cycle;
    for (int64_t start = 0; start < n; ++start) {
        if (visited[start]) continue;
        cycle.clear();
        int64_t j = start;
        while (!visited[j]) {
            visited[j] = 1;
            cycle.push_back(j);
            j = sa[j];
        }
        const int64_t L = (int64_t)cycle.size();
        for (int64_t k = 0; k < L; k += t) {
            const int64_t pos = cycle[(size_t)k];
            has[pos] = 1;
            val[pos] = cycle[(size_t)(((k - t) % L + L) % L)];
        }
    }
}

// Kärkkäinen phi-algorithm PLCP (semantics of ds/PLCPFromPhi.hpp:38-44,
// with explicit bounds instead of relying on the sentinel).
void tdc_plcp_from_phi(const uint8_t* text, int64_t n, const int32_t* phi,
                       int32_t* plcp) {
    int64_t l = 0;
    for (int64_t i = 0; i + 1 < n; ++i) {
        int64_t p = phi[i];
        while (i + l < n && p + l < n && text[i + l] == text[p + l]) ++l;
        plcp[i] = (int32_t)l;
        if (l) --l;
    }
    if (n > 0) plcp[n - 1] = 0;
}

// Random-access permutation helpers for the SA pipeline's derived arrays
// (ISAFromSA.hpp / PhiFromSA.hpp / LCPFromPLCP.hpp). numpy's fancy
// indexing is memory-latency-bound on 16M-scale scatters; issuing
// software prefetches ~32 iterations ahead overlaps the misses.

void tdc_inverse_perm(const int32_t* sa, int64_t n, int32_t* isa) {
    const int64_t D = 32;
    for (int64_t i = 0; i < n; ++i) {
        if (i + D < n) __builtin_prefetch(&isa[sa[i + D]], 1);
        isa[sa[i]] = (int32_t)i;
    }
}

void tdc_gather_i32(const int32_t* vals, const int32_t* idx, int64_t n,
                    int32_t* out) {
    const int64_t D = 32;
    for (int64_t i = 0; i < n; ++i) {
        if (i + D < n) __builtin_prefetch(&vals[idx[i + D]]);
        out[i] = vals[idx[i]];
    }
}

void tdc_phi_from_sa(const int32_t* sa, int64_t n, int32_t* phi) {
    if (n == 0) return;
    const int64_t D = 32;
    phi[sa[0]] = sa[n - 1];
    for (int64_t i = 1; i < n; ++i) {
        if (i + D < n) __builtin_prefetch(&phi[sa[i + D]], 1);
        phi[sa[i]] = sa[i - 1];
    }
}

}  // extern "C"

namespace {
// MSB-first bit cursor over the stream payload; bits past `valid` read 0
// (mirror of io/bitio.py BitReader semantics incl. EOF zero-padding).
struct BitCursor {
    const uint8_t* data;
    int64_t nbytes;
    int64_t pos;
    int64_t valid;
    bool eof() const { return pos >= valid; }
    int bit() {
        int64_t p = pos++;
        if (p >= valid) return 0;
        return (data[p >> 3] >> (7 - (p & 7))) & 1;
    }
    uint64_t read(int nb) {
        if (nb <= 0) return 0;
        int64_t p = pos;
        pos += nb;
        if (nb <= 56 && ((p >> 3) + 8) <= nbytes && p + nb <= valid) {
            uint64_t w = 0;
            const uint8_t* q = data + (p >> 3);
            for (int i = 0; i < 8; ++i) w = (w << 8) | q[i];
            return (w >> (64 - (p & 7) - nb)) & ((1ULL << nb) - 1);
        }
        uint64_t v = 0;
        for (int i = 0; i < nb; ++i) {
            int64_t q = p + i;
            int b = (q < valid) ? ((data[q >> 3] >> (7 - (q & 7))) & 1) : 0;
            v = (v << 1) | (uint64_t)b;
        }
        return v;
    }
};

inline int bits_for64(uint64_t x) { return x ? (64 - __builtin_clzll(x)) : 1; }

}  // namespace

extern "C" {
// Shared lzss stream parse (lzss/LZSSCoding.hpp:94-140 loop shape): after the
// caller decoded the header (n, flen_min, flen_max, fdist_max), parse
// [gap-flag | gap len | gap literals | src | len]* placing gap literals at
// their absolute positions in `out` and collecting factors. Literals are
// raw 8-bit (bit coder / degenerate huff) or canonical-Huffman codes
// (use_huff=1 with the table arrays). Returns factor count, -1 on a
// malformed stream; cursor_out[0] = decoded length.
int64_t tdc_lzss_stream_parse(const uint8_t* data, int64_t nbytes,
                              int64_t start_bit, int64_t valid_bits,
                              int64_t n, int64_t flen_min, int64_t flen_max,
                              int64_t fdist_max, int32_t use_huff,
                              const uint64_t* firstcodes, const int64_t* psl,
                              const uint8_t* ordered_syms, int32_t longest,
                              uint8_t* out, uint32_t* tgt, uint32_t* srcs,
                              uint32_t* lens, int64_t* cursor_out) {
    BitCursor cur{data, nbytes, start_bit, valid_bits};
    const int w_text = bits_for64((uint64_t)n);
    const int w_dist = bits_for64((uint64_t)fdist_max);
    const int w_len = bits_for64((uint64_t)(flen_max - flen_min));
    int64_t cursor = 0, nf = 0;
    while (!cur.eof()) {
        int64_t num = cur.bit() ? (int64_t)cur.read(w_dist) : 0;
        if (num) {
            if (cursor + num > n) return -1;
            if (use_huff) {
                for (int64_t i = 0; i < num; ++i) {
                    uint64_t value = 0;
                    int len = 0;
                    while (len < longest) {
                        value = (value << 1) | (uint64_t)cur.bit();
                        ++len;
                        if (value >= firstcodes[len - 1]) break;
                    }
                    out[cursor++] =
                        ordered_syms[psl[len - 1] +
                                     (int64_t)(value - firstcodes[len - 1])];
                }
            } else {
                for (int64_t i = 0; i < num; ++i)
                    out[cursor++] = (uint8_t)cur.read(8);
            }
        }
        if (!cur.eof()) {
            int64_t src = (int64_t)cur.read(w_text);
            int64_t ln = flen_min + (int64_t)cur.read(w_len);
            if (cursor + ln > n || src > n || nf >= n) return -1;
            tgt[nf] = (uint32_t)cursor;
            srcs[nf] = (uint32_t)src;
            lens[nf] = (uint32_t)ln;
            ++nf;
            cursor += ln;
        }
    }
    cursor_out[0] = cursor;
    return nf;
}

// DecodeBackBuffer factor resolution (lzss/LZSSDecodeBackBuffer.hpp):
// in-order byte-wise copies; overlapping self-referential factors replicate.
void tdc_lzss_apply_factors(uint8_t* out, const uint32_t* tgt,
                            const uint32_t* srcs, const uint32_t* lens,
                            int64_t nf) {
    for (int64_t j = 0; j < nf; ++j) {
        uint8_t* d = out + tgt[j];
        const uint8_t* s = out + srcs[j];
        for (uint32_t i = 0; i < lens[j]; ++i) d[i] = s[i];
    }
}
}  // extern "C"

// ---------------------------------------------------------------------------
// ESP (Edit-Sensitive Parsing) round: split the current symbol string into
// blocks of size 2/3 and name each block with a grammar rule. Exact mirror
// of the reference round logic: metablock splitting
// (esp/RoundContextImpl.hpp:17-55 split / :7-14 split_where), type-2
// alphabet reduction + landmark spanning (esp/meta_blocks.hpp:65-180
// eager_mb2, esp/landmarks.hpp:30-79 landmark_spanner tie-to-right),
// type-1/3 chunking (meta_blocks.hpp:33-63 eager_mb13), block adjustment
// (esp/BlockAdjust.hpp adjust_blocks) and rule naming in first-appearance
// order (esp/GrammarRules.hpp add; 3-blocks split into two 2-rules).
//
// Symbol spaces: input symbols are 0..alphabet-1; new rule j is referred
// to as alphabet + j inside rule pairs; out_next holds 0-based rule ids.

namespace esp_native {

struct TypedBlock {
    uint8_t len;
    uint8_t type;
};

inline size_t iter_log(size_t n) {  // esp/esp_math.hpp:8-14
    if (n < 7) return 0;
    if (n < 9) return 1;
    if (n < 17) return 2;
    if (n < 257) return 3;
    return 4;
}

inline uint64_t esp_label(uint64_t left, uint64_t right) {  // esp_math.hpp:16
    uint64_t diff = left ^ right;
    unsigned l = (unsigned)__builtin_ctzll(diff);
    return 2ull * l + ((right >> l) & 1);
}

inline bool needs_merge(const TypedBlock& a, const TypedBlock& b) {
    return a.len == 1 || b.len == 1;
}

inline size_t merge(TypedBlock& a, TypedBlock& b, uint8_t type) {
    size_t sum = a.len + b.len;
    if (sum == 2) {
        a.len = 2; b.len = 2; a.type = type; b.type = type; return 1;
    } else if (sum == 3) {
        a.len = 3; b.len = 3; a.type = type; b.type = type; return 1;
    } else {
        a.len = 2; b.len = 2; a.type = type; b.type = type; return 2;
    }
}

// adjust_blocks with the reference's 3-slot queue (BlockAdjust.hpp:38-131)
inline void adjust_blocks(std::vector<TypedBlock>& blocks) {
    if (blocks.size() < 2) return;
    std::vector<TypedBlock> q;  // front = q[0]
    size_t read = 0, write = 0;
    auto fill = [&]() {
        while (q.size() < 3 && read < blocks.size()) q.push_back(blocks[read++]);
    };
    auto step = [&]() -> bool {
        bool has_one = false;
        for (auto& e : q)
            if (e.len == 1) has_one = true;
        if (!has_one) return false;
        if (q.size() == 3) {
            TypedBlock& a = q[1];
            TypedBlock& b = q[2];
            if (needs_merge(a, b) && a.type == 2 && b.type == 2) {
                if (merge(a, b, 2) == 1) q.pop_back();
                return true;
            }
        }
        if (q.size() >= 2) {
            TypedBlock& a = q[0];
            TypedBlock& b = q[1];
            if (needs_merge(a, b) && a.type == 2 && b.type == 2) {
                if (merge(a, b, 2) == 1) q.erase(q.begin());
                return true;
            }
            if (needs_merge(a, b) && a.type == 3) {
                if (merge(a, b, 3) == 1) q.erase(q.begin());
                return true;
            }
            if (needs_merge(a, b) && (a.type == 1 || b.type == 1)) {
                if (merge(a, b, 1) == 1) q.erase(q.begin());
                return true;
            }
        }
        return false;  // v[0].len > 1 case
    };
    fill();
    while (!q.empty()) {
        do {
            fill();
        } while (step());
        blocks[write++] = q.front();
        q.erase(q.begin());
    }
    blocks.resize(write);
}

struct RoundState {
    std::vector<TypedBlock> blocks;
    std::vector<uint64_t> scratch;

    void push_block(uint8_t len, uint8_t type) {
        blocks.push_back(TypedBlock{len, type});
    }

    void eager_mb13(size_t len, uint8_t t) {  // meta_blocks.hpp:33-63
        size_t remaining = len;
        while (remaining) {
            if (remaining == 4) { push_block(2, t); push_block(2, t); return; }
            if (remaining == 3) { push_block(3, t); return; }
            if (remaining == 2) { push_block(2, t); return; }
            if (remaining == 1) { push_block(1, t); return; }
            push_block(3, t);
            remaining -= 3;
        }
    }

    void eager_mb2(const uint32_t* A, size_t L, size_t alphabet) {
        size_t t3 = std::min(iter_log(alphabet), L);
        eager_mb13(t3, 3);
        if (t3 == L) return;

        auto& buf = scratch;
        buf.assign(A, A + L);
        for (size_t s = 0; s < t3; ++s) {  // reduce to alphabet <= 6
            for (size_t i = 1; i < buf.size(); ++i)
                buf[i - 1] = esp_label(buf[i - 1], buf[i]);
            buf.pop_back();
        }
        // reduce to alphabet <= 3 (in-place neighbor-aware renaming)
        const size_t B = buf.size();
        for (uint64_t to_replace = 3; to_replace < 6; ++to_replace) {
            for (size_t i = 0; i < B; ++i) {
                if (buf[i] != to_replace) continue;
                uint64_t nb[2];
                int nn = 0;
                if (i > 0) nb[nn++] = buf[i - 1];
                if (i + 1 < B) nb[nn++] = buf[i + 1];
                uint64_t e = 0;
                for (int k = 0; k < nn; ++k)
                    if (nb[k] == e) ++e;
                for (int k = 0; k < nn; ++k)
                    if (nb[k] == e) ++e;
                buf[i] = e;
            }
        }
        // landmarks
        std::vector<uint8_t> lm(B, 0);
        for (size_t i = 0; i < B; ++i) {
            bool high = true;
            if (i > 0 && buf[i - 1] > buf[i]) high = false;
            if (i + 1 < B && buf[i + 1] > buf[i]) high = false;
            if (high) lm[i] = 1;
        }
        for (size_t i = 0; i < B; ++i) {
            bool low = true;
            if (i > 0 && buf[i - 1] < buf[i]) low = false;
            if (i + 1 < B && buf[i + 1] < buf[i]) low = false;
            if (low) {
                if ((i == 0 || lm[i - 1] == 0) && (i + 1 >= B || lm[i + 1] == 0))
                    lm[i] = 1;
            }
        }
        // landmark_spanner, tie_to_right = true (landmarks.hpp:30-79)
        struct Block {
            size_t left, right;
        };
        Block b0{0, 0}, b1{0, 0};
        int bi = 0;
        for (size_t i = 0; i < B; ++i) {
            if (!lm[i]) continue;
            b1.left = (i == 0) ? i : i - 1;
            b1.right = (i == B - 1) ? i : i + 1;
            if (bi > 0 && b1.left == b0.right) b0.right--;  // tie to right
            if (bi == 0) {
                bi = 1;
            } else {
                push_block((uint8_t)(b0.right - b0.left + 1), 2);
            }
            b0 = b1;
        }
        if (bi == 1) push_block((uint8_t)(b1.right - b1.left + 1), 2);
    }
};

}  // namespace esp_native

extern "C" {

// One ESP round. out_next cap: n/2+1; rules_l/r cap: n+1.
// Returns next length; *rules_count_out = number of new rules.
int64_t tdc_esp_round(const uint32_t* src, int64_t n, int64_t alphabet,
                      uint32_t* out_next, uint32_t* rules_l, uint32_t* rules_r,
                      int64_t* rules_count_out) {
    using namespace esp_native;
    RoundState st;
    // --- metablock split (RoundContextImpl.hpp:17-55)
    int64_t i = 0;
    while (i < n) {
        // non-repeating scan: j = first j in [i, n-1) with src[j]==src[j+1]
        int64_t j = n;
        for (int64_t k = i; k < n - 1; ++k)
            if (src[k] == src[k + 1]) {
                j = k;
                break;
            }
        if (j != i) {
            st.eager_mb2(src + i, (size_t)(j - i), (size_t)alphabet);
            i = j;
        }
        if (i >= n) break;
        // repeating scan: first k with src[k]!=src[k+1], then +1
        j = n;
        for (int64_t k = i; k < n - 1; ++k)
            if (src[k] != src[k + 1]) {
                j = k + 1;
                break;
            }
        if (j != i) {
            st.eager_mb13((size_t)(j - i), 1);
            i = j;
        }
    }
    adjust_blocks(st.blocks);

    // --- rule naming (GrammarRules semantics; dedup by hash)
    HashTrie map((size_t)n + 16);
    int64_t counter = 0;  // local 0-based rule ids
    auto add2 = [&](uint64_t a, uint64_t b) -> uint32_t {
        uint64_t key = (a << 32) | b;
        uint32_t found = map.find_or_insert(key, (uint32_t)counter);
        if (found == UINT32_MAX) {
            rules_l[counter] = (uint32_t)a;
            rules_r[counter] = (uint32_t)b;
            return (uint32_t)counter++;
        }
        return found;
    };
    int64_t pos = 0;
    int64_t m = 0;
    for (auto& b : st.blocks) {
        uint32_t name;
        if (b.len == 2) {
            name = add2(src[pos], src[pos + 1]);
        } else {
            uint32_t x = add2(src[pos], src[pos + 1]);
            name = add2((uint64_t)alphabet + x, src[pos + 2]);
        }
        out_next[m++] = name;
        pos += b.len;
    }
    if (pos != n) return -1;  // block coverage mismatch (should not happen)
    *rules_count_out = counter;
    return m;
}

// SLP::derive_text (esp/SLP.hpp:25-38): expand the straight-line program
// from the root with an explicit stack; symbols < 256 are terminals,
// rule x >= 256 expands to (l[x-256], r[x-256]).
// returns -1 when out_cap is too small, -2 on an out-of-range rule id,
// -3 on a cyclic rule graph (corrupt container; the caller raises).
// Cycle bound: a valid binary derivation emitting T <= out_cap terminals
// pops at most T terminals + (T-1 internal nodes + one left spine of
// length <= n_rules in an acyclic rule DAG), so any run exceeding
// 2*out_cap + n_rules + 2 pops can only be a cycle.
int64_t tdc_esp_derive(const int32_t* rl, const int32_t* rr, int64_t n_rules,
                       int64_t root, uint8_t* out, int64_t out_cap) {
    std::vector<int32_t> stack;
    stack.push_back((int32_t)root);
    int64_t n = 0;
    const int64_t max_pops = 2 * out_cap + n_rules + 2;
    int64_t pops = 0;
    while (!stack.empty()) {
        if (++pops > max_pops) return -3;
        int32_t x = stack.back();
        stack.pop_back();
        if (x < 0) return -2;
        if (x < 256) {
            if (n >= out_cap) return -1;
            out[n++] = (uint8_t)x;
        } else {
            if ((int64_t)x - 256 >= n_rules) return -2;
            stack.push_back(rr[x - 256]);
            stack.push_back(rl[x - 256]);
        }
    }
    return n;
}

// Canonical-code index decode over an unpacked bit array (the esp huff2
// D-coding decoder loop, esp/HuffmanCoder.hpp decode semantics): first-
// match rule value >= firstcode[len]; emits the ordered-symbol INDEX
// psl[len-1] + value - firstcode[len-1] so the caller maps through any
// symbol alphabet. Returns the new bit position.
// n_bits bounds the readable bit array; returns -1 on a truncated stream
// (the caller raises instead of reading out of bounds).
int64_t tdc_canonical_decode_idx(const uint8_t* bits, int64_t pos,
                                 int64_t n_bits, const int64_t* fc,
                                 const int64_t* psl, int64_t longest,
                                 int32_t* out_idx, int64_t count) {
    for (int64_t i = 0; i < count; ++i) {
        int64_t value = 0, len = 0;
        do {
            if (pos >= n_bits) return -1;
            value = (value << 1) | bits[pos++];
            ++len;
        } while (len < longest && value < fc[len - 1]);
        out_idx[i] = (int32_t)(psl[len - 1] + value - fc[len - 1]);
    }
    return pos;
}

// Arithmetic (range) coder hot loops, mirror of coders/ArithmeticCoder.hpp:
// 96-117 (setNewBounds) and :188-215 (block decode). C is the cumulative
// normalized count table; a code block is flushed whenever the remaining
// range drops below min_range. Returns the number of u64 codes emitted
// (out_codes must hold n + 2 entries; the trailing dummy is NOT included).
int64_t tdc_arith_encode(const uint8_t* data, int64_t n, const uint32_t* C,
                         uint64_t min_range, uint64_t* out_codes) {
    uint64_t lower = 0, upper = ~0ull;
    const uint64_t total = C[255];
    int64_t nc = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t range = upper - lower;
        if (range < min_range) {
            out_codes[nc++] = lower;
            lower = 0;
            upper = ~0ull;
            range = upper - lower;
        }
        uint8_t v = data[i];
        uint64_t off_u =
            range <= total ? range * C[v] / total : range / total * C[v];
        upper = lower + off_u;
        if (v != 0) {
            uint64_t off_l = range <= total ? range * C[v - 1] / total
                                            : range / total * C[v - 1];
            lower = lower + off_l;
        }
    }
    if (n > 0) out_codes[nc++] = lower;  // postProcessing final block
    return nc;
}

// Decode `literal_count` literals from the code-block sequence.
// syms/cums: codebook entries (symbol, cumulative normalized count).
int64_t tdc_arith_decode(const uint64_t* codes, int64_t ncodes,
                         const uint8_t* syms, const uint32_t* cums,
                         int32_t cbsize, uint64_t min_range,
                         int64_t literal_count, uint8_t* out) {
    if (cbsize <= 0) return 0;
    const uint64_t total = cums[cbsize - 1];
    int64_t cnt = 0;
    for (int64_t ci = 0; ci < ncodes && cnt < literal_count; ++ci) {
        uint64_t code = codes[ci];
        uint64_t lower = 0, upper = ~0ull;
        uint64_t range = upper - lower;
        while (min_range <= range && cnt < literal_count) {
            uint64_t interval_lower = lower;
            for (int32_t i = 0; i < cbsize; ++i) {
                uint64_t off = range <= total ? range * cums[i] / total
                                              : range / total * cums[i];
                upper = lower + off;
                if (code < upper) {
                    out[cnt++] = syms[i];
                    lower = interval_lower;
                    break;
                }
                interval_lower = upper;
            }
            range = upper - lower;
        }
    }
    return cnt;
}

// Longest strictly increasing subsequence of the n distinct values y, by
// patience sorting with predecessor links (the port's C++ form of
// compressors/esp_dcoding.py:_lis_indices, which picks the same indices):
// each value replaces the first tail >= it (a lower bound), links to the
// tail one layer down, and the chain is read back from the last layer's
// tail. Writes the chain's indices in increasing order to out (room for n)
// and returns its length.
int64_t tdc_lis_indices(const int64_t* y, int64_t n, int64_t* out) {
    if (n <= 0) return 0;
    std::vector<int64_t> tails, tails_idx, prev((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t val = y[i];
        const size_t j = (size_t)(std::lower_bound(tails.begin(), tails.end(), val) - tails.begin());
        if (j == tails.size()) {
            tails.push_back(val);
            tails_idx.push_back(i);
        } else {
            tails[j] = val;
            tails_idx[j] = i;
        }
        prev[(size_t)i] = j > 0 ? tails_idx[j - 1] : -1;
    }
    int64_t len = 0;
    for (int64_t k = tails_idx.back(); k != -1; k = prev[(size_t)k]) out[len++] = k;
    std::reverse(out, out + len);
    return len;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// lcpcomp

// Slotted binary max-heap with erase/decrease-key by ELEMENT INDEX — the
// shared engine of the lcpcomp heap strategies (heap/bheap/plcp). The
// operation sequences are identical to the previous per-function copies,
// so emitted factor sets are unchanged; for bheap/plcp the order is total
// anyway, making the heap implementation unobservable.
template <class Less>
struct SlottedMaxHeap {
    std::vector<int64_t> heap;  // heap of element indices
    std::vector<int64_t> slot;  // element index -> heap position (-1 = out)
    Less less;
    SlottedMaxHeap(int64_t n, Less l) : slot((size_t)n, -1), less(l) {}
    bool empty() const { return heap.empty(); }
    int64_t top() const { return heap[0]; }
    bool contains(int64_t idx) const { return slot[idx] >= 0; }
    void swap_slots(int64_t i, int64_t j) {
        std::swap(heap[i], heap[j]);
        slot[heap[i]] = i;
        slot[heap[j]] = j;
    }
    void sift_up(int64_t i) {
        while (i > 0 && less(heap[(i - 1) / 2], heap[i])) {
            swap_slots(i, (i - 1) / 2);
            i = (i - 1) / 2;
        }
    }
    void sift_down(int64_t i) {
        int64_t sz = (int64_t)heap.size();
        while (true) {
            int64_t l = 2 * i + 1, r = 2 * i + 2, m = i;
            if (l < sz && less(heap[m], heap[l])) m = l;
            if (r < sz && less(heap[m], heap[r])) m = r;
            if (m == i) break;
            swap_slots(i, m);
            i = m;
        }
    }
    void push_raw(int64_t idx) {  // bulk insert; call heapify() after
        slot[idx] = (int64_t)heap.size();
        heap.push_back(idx);
    }
    void heapify() {
        for (int64_t i = (int64_t)heap.size() / 2 - 1; i >= 0; --i)
            sift_down(i);
    }
    void push(int64_t idx) {
        push_raw(idx);
        sift_up((int64_t)heap.size() - 1);
    }
    void erase(int64_t idx) {
        int64_t s = slot[idx];
        if (s < 0) return;
        int64_t last = (int64_t)heap.size() - 1;
        if (s != last) swap_slots(s, last);
        slot[heap[last]] = -1;
        heap.pop_back();
        if (s < (int64_t)heap.size()) {
            sift_down(s);
            sift_up(s);
        }
    }
};

extern "C" {

// lcpcomp "arrays" factorization strategy (exact mirror of
// lcpcomp/compress/ArraysComp.hpp:36-119): candidates bucketed by LCP
// value; repeatedly take a maximal-LCP suffix array position, emit factor
// (sa[index] <- sa[index-1], lcp[index] chars), zero the LCP of replaced
// suffixes and clamp intersecting entries, pushing shrunk candidates down
// to their new bucket. Mutates lcp. Factors are emitted in max-LCP order
// (caller sorts by position). Returns factor count.
int64_t tdc_lcpcomp_arrays_factorize(const int32_t* sa, const int32_t* isa,
                                     int32_t* lcp, int64_t n,
                                     int64_t threshold, uint32_t* fpos,
                                     uint32_t* fsrc, uint32_t* flen) {
    int64_t max_lcp = 0;
    for (int64_t i = 0; i < n; ++i) max_lcp = std::max<int64_t>(max_lcp, lcp[i]);
    if (max_lcp + 1 <= threshold) return 0;
    const int64_t cand_length = max_lcp + 1 - threshold;
    std::vector<std::vector<uint32_t>> cand((size_t)cand_length);
    for (int64_t i = 1; i < n; ++i) {
        if (lcp[i] < threshold) continue;
        cand[lcp[i] - threshold].push_back((uint32_t)i);
    }
    int64_t nf = 0;
    for (int64_t maxlcp = max_lcp; maxlcp >= threshold; --maxlcp) {
        std::vector<uint32_t>& col = cand[maxlcp - threshold];
        for (size_t ci = 0; ci < col.size(); ++ci) {
            const uint32_t index = col[ci];
            const int64_t lcp_value = lcp[index];
            if (lcp_value < maxlcp) {  // resized: push down
                if (lcp_value < threshold) continue;  // erased
                cand[lcp_value - threshold].push_back(index);
                continue;
            }
            const int64_t pos_target = sa[index];
            const int64_t pos_source = sa[index - 1];
            const int64_t factor_length = lcp[index];
            fpos[nf] = (uint32_t)pos_target;
            fsrc[nf] = (uint32_t)pos_source;
            flen[nf] = (uint32_t)factor_length;
            ++nf;
            for (int64_t k = 0; k < factor_length; ++k)
                lcp[isa[pos_target + k]] = 0;
            const int64_t max_affect = std::min(factor_length, pos_target);
            for (int64_t k = 0; k < max_affect; ++k) {
                const int64_t ind_suffix = isa[pos_target - k - 1];
                lcp[ind_suffix] = std::min<int32_t>((int32_t)(k + 1), lcp[ind_suffix]);
            }
        }
        col.clear();
    }
    return nf;
}

// lcpcomp "heap" strategy (lcpcomp/compress/MaxHeapStrategy.hpp:22-103 +
// ds/ArrayMaxHeap.hpp): max-heap over LCP values; repeatedly pop the
// maximum, emit the factor, remove overlapped suffixes and decrease keys
// of intersecting ones. (Tie order among equal LCP values is heap-shape
// dependent, here as in the reference.) Returns factor count.
int64_t tdc_lcpcomp_heap_factorize(const int32_t* sa, const int32_t* isa,
                                   const int32_t* lcp, int64_t n,
                                   int64_t threshold, uint32_t* fpos,
                                   uint32_t* fsrc, uint32_t* flen) {
    std::vector<int32_t> key(lcp, lcp + n);
    auto less = [&](int64_t a, int64_t b) { return key[a] < key[b]; };
    SlottedMaxHeap<decltype(less)> heap(n, less);
    for (int64_t i = 1; i < n; ++i)
        if (lcp[i] >= threshold) heap.push_raw(i);
    heap.heapify();

    int64_t nf = 0;
    while (!heap.empty()) {
        int64_t m = heap.top();
        int64_t p = sa[m];
        int64_t src = sa[m - 1];
        int64_t len = key[m];
        fpos[nf] = (uint32_t)p;
        fsrc[nf] = (uint32_t)src;
        flen[nf] = (uint32_t)len;
        ++nf;
        for (int64_t k = 0; k < len; ++k) heap.erase(isa[p + k]);
        for (int64_t k = 0; k < len && p > k; ++k) {
            int64_t s = p - k - 1;
            int64_t i = isa[s];
            if (heap.contains(i) && s + key[i] > p) {
                int64_t l = p - s;
                if (l >= threshold) {
                    key[i] = (int32_t)l;
                    heap.sift_down(heap.slot[i]);
                } else {
                    heap.erase(i);
                }
            }
        }
    }
    return nf;
}

// BoostHeap strategy ("bheap", compressors/lcpcomp/compress/BoostHeap.hpp:
// 24-119): same greedy max-LCP selection as the heap strategy but with the
// reference's total order — ties on LCP break toward the SMALLER text
// position sa[i] — so the emitted factor set matches the Boost-gated
// reference strategy exactly (any max-heap with the same comparator yields
// the same top sequence; the order is total, so the pairing heap vs this
// slotted binary heap is observationally identical).
int64_t tdc_lcpcomp_bheap_factorize(const int32_t* sa, const int32_t* isa,
                                    const int32_t* lcp, int64_t n,
                                    int64_t threshold, uint32_t* fpos,
                                    uint32_t* fsrc, uint32_t* flen) {
    std::vector<int32_t> key(lcp, lcp + n);
    auto less = [&](int64_t a, int64_t b) {
        if (key[a] != key[b]) return key[a] < key[b];
        return sa[a] > sa[b];  // equal LCP: smaller text position wins
    };
    SlottedMaxHeap<decltype(less)> heap(n, less);
    for (int64_t i = 1; i < n; ++i)
        if (lcp[i] >= threshold) heap.push_raw(i);
    heap.heapify();

    int64_t nf = 0;
    while (!heap.empty()) {
        int64_t m = heap.top();
        int64_t p = sa[m];
        int64_t src = sa[m - 1];
        int64_t len = key[m];
        fpos[nf] = (uint32_t)p;
        fsrc[nf] = (uint32_t)src;
        flen[nf] = (uint32_t)len;
        ++nf;
        for (int64_t k = 0; k < len; ++k) heap.erase(isa[p + k]);
        for (int64_t k = 0; k < len && p > k; ++k) {
            int64_t s = p - k - 1;
            int64_t i = isa[s];
            if (heap.contains(i) && s + key[i] > p) {
                int64_t l = p - s;
                if (l >= threshold) {
                    key[i] = (int32_t)l;
                    heap.sift_down(heap.slot[i]);
                } else {
                    heap.erase(i);
                }
            }
        }
    }
    return nf;
}

// PLCP peak strategy ("plcp", compressors/lcpcomp/compress/
// PLCPStrategy.hpp:20-170): stream the PLCP array left to right, keep the
// current ascent's peaks in a max-heap ordered by (lcp, smaller pos),
// and when a peak group ends (i - lastpos >= lastpos_lcp) factorize the
// peaks greedily, substituting right peaks and trimming left overlaps.
// Semantic mirror of the Boost-gated reference strategy; the Poi order is
// total, so the heap implementation does not affect the output.
int64_t tdc_lcpcomp_plcp_factorize(const int32_t* sa, const int32_t* isa,
                                   const int32_t* plcp, int64_t n,
                                   int64_t threshold, uint32_t* fpos,
                                   uint32_t* fsrc, uint32_t* flen) {
    struct Poi {
        int64_t pos, lcp, no;
    };
    std::vector<Poi> pois;  // by handle number (insertion order)

    auto less = [&](int64_t a, int64_t b) {
        if (pois[a].lcp != pois[b].lcp) return pois[a].lcp < pois[b].lcp;
        return pois[a].pos > pois[b].pos;  // equal lcp: smaller pos wins
    };
    SlottedMaxHeap<decltype(less)> h(0, less);
    auto erase_no = [&](int64_t no) { h.erase(no); };
    auto emplace = [&](int64_t pos, int64_t lcp, int64_t no) {
        if ((int64_t)pois.size() <= no) {
            pois.resize((size_t)no + 1);
            h.slot.resize((size_t)no + 1, -1);
        }
        pois[(size_t)no] = Poi{pos, lcp, no};
        h.push(no);
    };

    int64_t nf = 0;
    int64_t lastpos = 0, lastpos_lcp = 0;
    int64_t handle_count = 0;
    for (int64_t i = 0; i + 1 < n; ++i) {
        const int64_t plcp_i = plcp[i];
        if (h.empty()) {
            if (plcp_i >= threshold) {
                emplace(i, plcp_i, handle_count++);
                lastpos = i;
                lastpos_lcp = plcp_i;
            }
            continue;
        }
        if (i - lastpos >= lastpos_lcp || i + 1 == n) {
            while (!h.empty()) {
                const Poi top = pois[(size_t)h.top()];
                const int64_t source = sa[isa[top.pos] - 1];
                fpos[nf] = (uint32_t)top.pos;
                fsrc[nf] = (uint32_t)source;
                flen[nf] = (uint32_t)top.lcp;
                ++nf;
                const int64_t next_pos = top.pos;
                {
                    int64_t newlcp_peak = 0;
                    bool peak_exists = false;
                    if (top.pos + top.lcp < i) {
                        for (int64_t j = top.no + 1; j < handle_count; ++j) {
                            if (!h.contains(j)) continue;
                            const Poi poi = pois[(size_t)j];
                            if (poi.pos < next_pos + top.lcp) {
                                erase_no(j);
                                if (poi.lcp + poi.pos > next_pos + top.lcp) {
                                    const int64_t remaining =
                                        poi.lcp + poi.pos - (next_pos + top.lcp);
                                    if (remaining > newlcp_peak)
                                        newlcp_peak = remaining;
                                }
                            } else if (poi.pos == next_pos + top.lcp) {
                                peak_exists = true;
                            } else {
                                break;
                            }
                        }
                    }
                    if (!peak_exists && newlcp_peak >= threshold) {
                        emplace(next_pos + top.lcp, newlcp_peak, top.no + 1);
                    }
                }
                erase_no(top.no);
                for (int64_t j = handle_count - 1; j >= 0; --j) {
                    if (!h.contains(j)) continue;
                    Poi& poi = pois[(size_t)j];
                    if (poi.pos > next_pos) continue;
                    const int64_t newlcp = next_pos - poi.pos;
                    if (newlcp < poi.lcp) {
                        if (newlcp < threshold) {
                            erase_no(j);
                        } else {
                            poi.lcp = newlcp;
                            h.sift_down(h.slot[j]);
                        }
                    } else {
                        break;
                    }
                }
            }
            handle_count = 0;
            pois.clear();
            h.slot.clear();
            --i;
            continue;
        }
        if (plcp_i <= lastpos_lcp) continue;
        emplace(i, plcp_i, handle_count++);
        lastpos = i;
        lastpos_lcp = plcp_i;
    }
    return nf;
}

// FactorBuffer::flatten (lzss/LZSSFactors.hpp:79-132): rewrite factor
// sources that point into other factors to their (transitively) flattened
// source when fully contained. Factors must be sorted by pos.
void tdc_lcpcomp_flatten(uint32_t* fpos, uint32_t* fsrc, uint32_t* flen,
                         int64_t nf) {
    if (nf == 0) return;
    const int64_t map_size = (int64_t)fpos[nf - 1] + flen[nf - 1];
    std::vector<uint32_t> fmap((size_t)map_size, 0);  // pos -> factor id + 1
    for (int64_t i = 0; i < nf; ++i)
        for (uint32_t j = 0; j < flen[i]; ++j) fmap[fpos[i] + j] = (uint32_t)i + 1;
    for (int64_t i = 0; i < nf; ++i) {
        int64_t src = fsrc[i];
        int64_t depth = 0;
        while (src < map_size && fmap[src]) {
            const int64_t s = fmap[src] - 1;
            const int64_t d = src - fpos[s];
            if (d + flen[i] <= flen[s]) {
                src = fsrc[s] + d;
                ++depth;
            } else {
                break;
            }
        }
        if (depth) fsrc[i] = (uint32_t)src;
    }
}

// lcpcomp scan decoding (lcpcomp/decompress/ScanDec.hpp): buffer starts
// with the gap literals placed (0 = empty); factors arrive in stream order
// with absolute target positions. Parse-time immediate copies, `scans`
// lazy passes, then the eager pass with forward-reference buckets
// (recursion converted to an explicit stack). Returns 0 on success.
int32_t tdc_lcpcomp_scan_decode(uint8_t* buffer, int64_t n,
                                const uint32_t* tgt0, const uint32_t* src0,
                                const uint32_t* len0, int64_t nf0,
                                int64_t scans) {
    // parse-phase immediate copies (ScanDec::decode_factor :221-236)
    std::vector<uint32_t> tgt, src, len;
    tgt.reserve((size_t)nf0);
    src.reserve((size_t)nf0);
    len.reserve((size_t)nf0);
    for (int64_t j = 0; j < nf0; ++j) {
        bool stored = false;
        for (uint32_t i = 0; i < len0[j]; ++i) {
            const int64_t sp = (int64_t)src0[j] + i;
            if (buffer[sp]) {
                buffer[tgt0[j] + i] = buffer[sp];
            } else if (!stored) {
                stored = true;
                tgt.push_back(tgt0[j] + i);
                src.push_back((uint32_t)sp);
                len.push_back(len0[j] - i);
            }
        }
    }
    // lazy scans (ScanDec::decode_lazy_ :180-193)
    for (int64_t s = 0; s < scans; ++s) {
        for (size_t j = 0; j < tgt.size(); ++j) {
            for (uint32_t i = 0; i < len[j]; ++i)
                buffer[tgt[j] + i] = buffer[src[j] + i];
        }
    }
    // eager pass (EagerScanDec :26-135)
    std::vector<int32_t> rank((size_t)n, -1);
    int64_t empties = 0;
    for (int64_t i = 0; i < n; ++i)
        if (!buffer[i]) rank[i] = (int32_t)empties++;
    std::vector<std::vector<uint32_t>> fwd((size_t)empties);
    std::vector<uint32_t> stack;
    auto decode_literal_at = [&](uint32_t pos, uint8_t c) {
        stack.clear();
        stack.push_back(pos);
        while (!stack.empty()) {
            uint32_t p = stack.back();
            stack.pop_back();
            buffer[p] = c;
            const int32_t r = rank[p];
            if (r >= 0 && !fwd[r].empty()) {
                for (uint32_t q : fwd[r]) stack.push_back(q);
                fwd[r].clear();
                fwd[r].shrink_to_fit();
            }
        }
    };
    for (size_t j = 0; j < tgt.size(); ++j) {
        for (uint32_t i = 0; i < len[j]; ++i) {
            const int64_t sp = (int64_t)src[j] + i;
            if (buffer[sp]) {
                decode_literal_at(tgt[j] + i, buffer[sp]);
            } else {
                fwd[rank[sp]].push_back(tgt[j] + i);
            }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (!buffer[i] && i + 1 != n) return -1;  // undecodable position
    return 0;
}

// lcpcomp "max_lcp" strategy (lcpcomp/compress/MaxLCPStrategy.hpp:22-99 over
// MaxLCPSuffixList.hpp): a bucket list sorted by LCP descending where
// insertion goes to the bucket *front* (most-recent-first tie order,
// MaxLCPSuffixList::insert :80-123). Realized as per-LCP LIFO stacks with
// lazy deletion: stale entries (removed or decrease-keyed away) are skipped
// when popped. Emits the same factors as the reference list walk.
int64_t tdc_lcpcomp_maxlcp_factorize(const int32_t* sa, const int32_t* isa,
                                     const int32_t* lcp, int64_t n,
                                     int64_t threshold, uint32_t* fpos,
                                     uint32_t* fsrc, uint32_t* flen) {
    int64_t max_lcp = 0;
    for (int64_t i = 1; i < n; ++i) max_lcp = std::max<int64_t>(max_lcp, lcp[i]);
    if (max_lcp < threshold) return 0;
    std::vector<int32_t> key(lcp, lcp + n);
    std::vector<uint8_t> alive((size_t)n, 0);
    std::vector<std::vector<uint32_t>> bucket((size_t)max_lcp + 1);
    for (int64_t i = 1; i < n; ++i) {
        if (lcp[i] >= threshold) {
            bucket[lcp[i]].push_back((uint32_t)i);
            alive[i] = 1;
        }
    }
    int64_t nf = 0;
    for (int64_t cur = max_lcp; cur >= threshold;) {
        std::vector<uint32_t>& b = bucket[cur];
        if (b.empty()) {
            --cur;
            continue;
        }
        const uint32_t m = b.back();
        b.pop_back();
        if (!alive[m] || key[m] != cur) continue;  // stale entry
        const int64_t p = sa[m];
        const int64_t len = key[m];
        fpos[nf] = (uint32_t)p;
        fsrc[nf] = (uint32_t)sa[m - 1];
        flen[nf] = (uint32_t)len;
        ++nf;
        // remove overlapped entries (MaxLCPStrategy.hpp:73-78)
        for (int64_t k = 0; k < len; ++k) alive[isa[p + k]] = 0;
        // correct intersecting entries (:81-94)
        for (int64_t k = 0; k < len && p > k; ++k) {
            const int64_t s = p - k - 1;
            const int64_t i = isa[s];
            if (alive[i] && s + key[i] > p) {
                const int64_t l = p - s;
                if (l >= threshold) {
                    key[i] = (int32_t)l;
                    bucket[l].push_back((uint32_t)i);
                } else {
                    alive[i] = 0;
                }
            }
        }
    }
    return nf;
}

// lcpcomp "plcppeaks" strategy (lcpcomp/compress/PLCPPeaksStrategy.hpp:
// 33-80): a single left-to-right pass over the PLCP array taking every
// local peak >= threshold as a factor and skipping its length.
int64_t tdc_lcpcomp_plcppeaks_factorize(const int32_t* sa, const int32_t* isa,
                                        const int32_t* plcp, int64_t n,
                                        int64_t threshold, uint32_t* fpos,
                                        uint32_t* fsrc, uint32_t* flen) {
    int64_t nf = 0;
    int64_t last_replacement_pos = 0;
    for (int64_t i = 0; i + 1 < n;) {
        if ((i == last_replacement_pos || plcp[i] > plcp[i - 1]) &&
            plcp[i] > plcp[i + 1] && plcp[i] >= threshold) {
            fpos[nf] = (uint32_t)i;
            fsrc[nf] = (uint32_t)sa[isa[i] - 1];
            flen[nf] = (uint32_t)plcp[i];
            ++nf;
            i += plcp[i];
            last_replacement_pos = i - 1;
        } else {
            ++i;
        }
    }
    return nf;
}

// lcpcomp "compact" decoding (lcpcomp/decompress/CompactDec.hpp:39-117):
// fully eager — no lazy scans; every unresolved source position gets a
// forward bucket, resolved transitively the moment its literal is decoded
// (recursion converted to an explicit stack). Gap literals are pre-placed
// in the buffer by the stream parse, so factor processing in target order
// is exactly the reference's interleaved decode_literal/decode_factor walk.
int32_t tdc_lcpcomp_compact_decode(uint8_t* buffer, int64_t n,
                                   const uint32_t* tgt, const uint32_t* src,
                                   const uint32_t* len, int64_t nf) {
    std::vector<std::vector<uint32_t>> fwd((size_t)n);
    std::vector<uint32_t> stack;
    auto decode_literal_at = [&](uint32_t pos, uint8_t c) {
        stack.clear();
        stack.push_back(pos);
        while (!stack.empty()) {
            uint32_t p = stack.back();
            stack.pop_back();
            buffer[p] = c;
            if (!fwd[p].empty()) {
                for (uint32_t q : fwd[p]) stack.push_back(q);
                fwd[p].clear();
                fwd[p].shrink_to_fit();
            }
        }
    };
    for (int64_t j = 0; j < nf; ++j) {
        for (uint32_t i = 0; i < len[j]; ++i) {
            const int64_t sp = (int64_t)src[j] + i;
            if (buffer[sp]) {
                decode_literal_at(tgt[j] + i, buffer[sp]);
            } else {
                fwd[sp].push_back(tgt[j] + i);
            }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (!buffer[i] && i + 1 != n) return -1;  // undecodable position
    return 0;
}

// Queue-list decoder (capability mirror of
// lcpcomp/decompress/DecodeQueueListBuffer.hpp:12-86): replays the stream
// in cursor order — literals resolve their own position, factor positions
// copy immediately when the source is already decoded and otherwise queue
// the target on the source's per-position forward list; resolving a
// position propagates through its list (iteratively, not recursively).
// buffer arrives with literals pre-placed (0 = undecoded factor target);
// factors are in stream (target) order.
int32_t tdc_lcpcomp_queuelist_decode(uint8_t* buffer, int64_t n,
                                     const uint32_t* tgt, const uint32_t* src,
                                     const uint32_t* len, int64_t nf) {
    std::vector<uint8_t> decoded((size_t)n, 0);
    for (int64_t j = 0; j < nf; ++j)  // factor spans start undecoded
        for (uint32_t i = 0; i < len[j]; ++i) decoded[tgt[j] + i] = 2;
    for (int64_t i = 0; i < n; ++i) decoded[i] = decoded[i] != 2;

    std::vector<std::vector<uint32_t>> fwd((size_t)n);
    std::vector<uint32_t> stack;
    auto decode_literal_at = [&](uint32_t pos, uint8_t c) {
        stack.clear();
        stack.push_back(pos);
        while (!stack.empty()) {
            uint32_t p = stack.back();
            stack.pop_back();
            buffer[p] = c;
            decoded[p] = 1;
            if (!fwd[p].empty()) {
                for (uint32_t q : fwd[p]) stack.push_back(q);
                std::vector<uint32_t>().swap(fwd[p]);
            }
        }
    };

    int64_t cursor = 0, f = 0;
    while (cursor < n) {
        if (f < nf && cursor == (int64_t)tgt[f]) {
            for (uint32_t i = 0; i < len[f]; ++i, ++cursor) {
                const int64_t sp = (int64_t)src[f] + i;
                if (decoded[sp])
                    decode_literal_at((uint32_t)cursor, buffer[sp]);
                else
                    fwd[sp].push_back((uint32_t)cursor);
            }
            ++f;
        } else {
            decode_literal_at((uint32_t)cursor, buffer[cursor]);
            ++cursor;
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (!decoded[i] && i + 1 != n) return -1;
    return 0;
}

// Multimap decoder (capability mirror of
// lcpcomp/decompress/MultiMapBuffer.hpp:12-160): stream replay copies
// eagerly where possible and stores each factor's unresolved remainder
// once; then `lazy` plain copy rounds over the stored factors; finally an
// eager pass that queues still-unresolved positions in an
// unordered_multimap<src, tgt> and propagates through it.
int32_t tdc_lcpcomp_multimap_decode(uint8_t* buffer, int64_t n,
                                    const uint32_t* tgt, const uint32_t* src,
                                    const uint32_t* len, int64_t nf,
                                    int64_t lazy) {
    std::vector<uint8_t> decoded((size_t)n, 0);
    for (int64_t j = 0; j < nf; ++j)
        for (uint32_t i = 0; i < len[j]; ++i) decoded[tgt[j] + i] = 2;
    for (int64_t i = 0; i < n; ++i) decoded[i] = decoded[i] != 2;

    // stream replay (decode_factor): immediate copies + remainder store
    std::vector<uint32_t> r_tgt, r_src, r_len;
    for (int64_t j = 0; j < nf; ++j) {
        bool stored = false;
        for (uint32_t i = 0; i < len[j]; ++i) {
            const int64_t sp = (int64_t)src[j] + i;
            const uint32_t tp = tgt[j] + i;
            if (decoded[sp]) {
                buffer[tp] = buffer[sp];
                decoded[tp] = 1;
            } else if (!stored) {
                stored = true;
                r_tgt.push_back(tp);
                r_src.push_back((uint32_t)sp);
                r_len.push_back(len[j] - i);
            }
        }
    }
    // lazy rounds (decode_lazy_): plain copies, no propagation
    for (int64_t round = 0; round < lazy; ++round) {
        for (size_t j = 0; j < r_tgt.size(); ++j) {
            for (uint32_t i = 0; i < r_len[j]; ++i) {
                const int64_t sp = (int64_t)r_src[j] + i;
                if (decoded[sp]) {
                    buffer[r_tgt[j] + i] = buffer[sp];
                    decoded[r_tgt[j] + i] = 1;
                }
            }
        }
    }
    // eager pass (decode_eagerly) with multimap propagation
    std::unordered_multimap<uint32_t, uint32_t> fwd;
    fwd.max_load_factor(0.8f);
    std::vector<uint32_t> stack;
    auto decode_literal_at = [&](uint32_t pos, uint8_t c) {
        stack.clear();
        stack.push_back(pos);
        while (!stack.empty()) {
            uint32_t p = stack.back();
            stack.pop_back();
            buffer[p] = c;
            decoded[p] = 1;
            auto range = fwd.equal_range(p);
            for (auto it = range.first; it != range.second; ++it)
                stack.push_back(it->second);
            fwd.erase(range.first, range.second);
        }
    };
    for (size_t j = 0; j < r_tgt.size(); ++j) {
        for (uint32_t i = 0; i < r_len[j]; ++i) {
            const int64_t sp = (int64_t)r_src[j] + i;
            const uint32_t tp = r_tgt[j] + i;
            if (decoded[tp]) continue;  // resolved by a lazy round
            if (decoded[sp])
                decode_literal_at(tp, buffer[sp]);
            else
                fwd.emplace((uint32_t)sp, tp);
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (!decoded[i] && i + 1 != n) return -1;
    return 0;
}

}  // extern "C"

extern "C" {

// RLE decode (RunLengthEncoder.hpp:37-50): a doubled character announces a
// run header followed by a vbyte run length (+offset). Returns output
// length, or -1 if cap exceeded.
int64_t tdc_rle_decode(const uint8_t* in, int64_t n, int64_t offset,
                       uint8_t* out, int64_t cap) {
    int64_t pos = 0;
    int64_t i = 0;
    int last = -1;
    while (i < n) {
        uint8_t c = in[i++];
        if (pos >= cap) return -1;
        out[pos++] = c;
        if ((int)c == last) {
            // vbyte run length follows
            uint64_t run = 0;
            int shift = 0;
            while (i < n) {
                uint8_t b = in[i++];
                run |= (uint64_t)(b & 0x7F) << shift;
                shift += 7;
                if (!(b & 0x80)) break;
            }
            int64_t r = (int64_t)run - offset;
            if (pos + (r > 0 ? r : 0) > cap) return -1;
            for (int64_t k = 0; k < r; ++k) out[pos++] = c;
            last = -1;  // run consumed; next char starts fresh
        } else {
            last = c;
        }
    }
    return pos;
}

// MTF decode: exact 256-entry table simulation
// (compressors/MTFCompressor.hpp:36-43).
void tdc_mtf_decode(const uint8_t* in, int64_t n, uint8_t* out) {
    uint8_t table[256];
    for (int i = 0; i < 256; ++i) table[i] = (uint8_t)i;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t v = in[i];
        uint8_t c = table[v];
        std::memmove(table + 1, table, v);
        table[0] = c;
        out[i] = c;
    }
}

// MTF encode: exact table simulation (MTFCompressor.hpp:17-29).
void tdc_mtf_encode(const uint8_t* in, int64_t n, uint8_t* out) {
    uint8_t table[256];
    for (int i = 0; i < 256; ++i) table[i] = (uint8_t)i;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = in[i];
        int v = 0;
        while (table[v] != c) ++v;
        std::memmove(table + 1, table, v);
        table[0] = c;
        out[i] = (uint8_t)v;
    }
}

// BWT LF-walk reconstruction (ds/bwt.hpp:84-95); out has length n-1.
void tdc_bwt_walk(const uint8_t* bwt, const int64_t* lf, int64_t n,
                  uint8_t* out) {
    int64_t i = 0;
    for (int64_t j = 1; j < n; ++j) {
        out[n - 1 - j] = bwt[i];
        i = lf[i];
    }
}

// LZSS sliding-window factorization (exact semantics of
// LZSSSlidingWindowCompressor::compress, LZSSSlidingWindowCompressor.hpp:
// 39-120): brute-force longest match >= threshold in the last `window`
// positions, leftmost match preferred, lookahead limited to the buffer end
// (match length <= window). Emits per token: kind[t] = 1 for a factor with
// (pos, delta=pos-src, len) or 0 for a literal (char in flen slot).
// Returns token count.
int64_t tdc_lzss_window_parse(const uint8_t* data, int64_t n, int64_t window,
                              int64_t threshold, uint8_t* kind, uint32_t* fpos,
                              uint32_t* fdelta, uint32_t* flen) {
    int64_t nt = 0;
    int64_t ahead = 0;
    while (ahead < n) {
        int64_t limit = ahead + window < n ? ahead + window : n;  // buffer end
        int64_t fnum = 0, fsrc = 0;
        int64_t k0 = ahead > window ? ahead - window : 0;
        for (int64_t k = k0; k < ahead; ++k) {
            int64_t j = 0;
            while (ahead + j < limit && data[k + j] == data[ahead + j]) ++j;
            if (j >= threshold && j > fnum) {
                fnum = j;
                fsrc = k;
            }
        }
        if (fnum > 0) {
            kind[nt] = 1;
            fpos[nt] = (uint32_t)ahead;
            fdelta[nt] = (uint32_t)(ahead - fsrc);
            flen[nt] = (uint32_t)fnum;
            ahead += fnum;
        } else {
            kind[nt] = 0;
            fpos[nt] = (uint32_t)ahead;
            fdelta[nt] = 0;
            flen[nt] = data[ahead];
            ahead += 1;
        }
        ++nt;
    }
    return nt;
}

// RePair grammar construction (exact mirror of RePairCompressor::compress,
// compressors/RePairCompressor.hpp:96-177): rounds of count-most-frequent-
// digram over a linked skip list, replace all its occurrences with a fresh
// nonterminal. Tie-breaking matches the reference: the winning digram is
// the first to *reach* the maximal count in scan order. text: in = bytes
// widened to u32, out = final start-rule symbols compacted to the front
// (*seq_len). Returns #rules.
int64_t tdc_repair_build(uint32_t* text, int64_t n, int64_t max_rules,
                         uint32_t* rules_l, uint32_t* rules_r,
                         int64_t* seq_len) {
    if (max_rules == 0) max_rules = INT64_MAX;
    std::vector<int64_t> next((size_t)n);
    for (int64_t i = 0; i < n; ++i) next[i] = i + 1;
    int64_t num_rules = 0;
    if (n > 0) {
        while (num_rules < max_rules) {
            // count digrams; the table is sized for the live sequence
            std::vector<int64_t> cnt;
            HashTrie map((size_t)std::min<int64_t>(n / 2 + 16, 1 << 21));
            uint64_t max_di = 0;
            int64_t max_count = 0;
            int64_t i = 0;
            while (i < n - 1) {
                int64_t j = next[i];
                if (j >= n) break;
                uint64_t di = ((uint64_t)text[i] << 32) | text[j];
                uint32_t slot = map.find_or_insert(di, (uint32_t)cnt.size());
                int64_t c;
                if (slot == UINT32_MAX) {
                    cnt.push_back(1);
                    c = 1;
                } else {
                    c = ++cnt[slot];
                }
                if (c > max_count) {
                    max_count = c;
                    max_di = di;
                }
                i = j;
            }
            if (max_count <= 1) break;
            uint32_t new_sym = 256 + (uint32_t)num_rules;
            rules_l[num_rules] = (uint32_t)(max_di >> 32);
            rules_r[num_rules] = (uint32_t)max_di;
            ++num_rules;
            i = 0;
            while (i < n - 1) {
                int64_t j = next[i];
                if (j >= n) break;
                uint64_t di = ((uint64_t)text[i] << 32) | text[j];
                if (di == max_di) {
                    text[i] = new_sym;
                    next[i] = next[j];
                }
                i = next[i];
            }
        }
    }
    // compact the start rule
    int64_t m = 0;
    for (int64_t i = 0; i < n; i = next[i]) text[m++] = text[i];
    *seq_len = m;
    return num_rules;
}

// RePair expansion (RePairCompressor.hpp:274-284, recursion made
// iterative). Returns output length, -1 if cap exceeded, -2 for a rule
// reference past the rules.
int64_t tdc_repair_expand(const uint32_t* rules_l, const uint32_t* rules_r,
                          int64_t nrules, const uint32_t* seq, int64_t seq_len,
                          uint8_t* out, int64_t cap) {
    std::vector<uint32_t> stack;
    int64_t pos = 0;
    for (int64_t s = 0; s < seq_len; ++s) {
        stack.push_back(seq[s]);
        while (!stack.empty()) {
            uint32_t x = stack.back();
            stack.pop_back();
            if (x < 256) {
                if (pos >= cap) return -1;
                out[pos++] = (uint8_t)x;
            } else {
                uint32_t r = x - 256;
                if ((int64_t)r >= nrules) return -2;
                stack.push_back(rules_r[r]);  // right expanded after left
                stack.push_back(rules_l[r]);
            }
        }
    }
    return pos;
}

}  // extern "C"

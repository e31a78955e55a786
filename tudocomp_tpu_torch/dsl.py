"""The algorithm-string DSL: parser + evaluator.

Reproduces tudocomp's option-string language
(include/tudocomp/AlgorithmStringParser.hpp:94-296 and
include/tudocomp/util/algorithm_parser/*):

    lzss_lcp(coder=huff, threshold=3)
    bwt:rle:mtf:encode(huff)        # chain sugar: a:b == chain(a, b)

Grammar:
    value   := ident [ '(' args ')' ] | string | number
    args    := [ arg (',' arg)* ]
    arg     := [ident '='] value
    chain   := value (':' value)*   (right-folded into chain(a, chain(b, c)))

Evaluation matches a parsed AST against an algorithm's declared signature:
positional args fill declared options in declaration order, keyword args by
name, missing options take declared defaults (recursively evaluated).
The port's copy of tudocomp_tpu/dsl.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Union

from .meta import AlgorithmValue, Meta


class ParseError(ValueError):
    pass


@dataclass
class AstValue:
    """A parsed (not yet evaluated) value: string literal or invocation."""

    name: str
    is_invocation: bool = False
    args: list["AstArg"] = field(default_factory=list)

    def __str__(self) -> str:
        if not self.is_invocation:
            return self.name
        inner = ", ".join(str(a) for a in self.args)
        return f"{self.name}({inner})" if self.args else self.name


@dataclass
class AstArg:
    value: AstValue
    keyword: Optional[str] = None

    def __str__(self) -> str:
        return f"{self.keyword}={self.value}" if self.keyword else str(self.value)


class Parser:
    """Recursive-descent parser for the DSL (ASTDef.hpp / AlgorithmAST.hpp)."""

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def _skip_ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n\r":
            self.pos += 1

    def _peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def _expect(self, ch: str) -> None:
        self._skip_ws()
        if self._peek() != ch:
            raise ParseError(
                f"expected {ch!r} at position {self.pos} in {self.text!r}"
            )
        self.pos += 1

    def _ident(self) -> str:
        self._skip_ws()
        start = self.pos
        while self.pos < len(self.text) and (
            self.text[self.pos].isalnum() or self.text[self.pos] in "_.+-"
        ):
            self.pos += 1
        if start == self.pos:
            raise ParseError(f"expected identifier at {self.pos} in {self.text!r}")
        return self.text[start : self.pos]

    def _string(self) -> str:
        quote = self._peek()
        self.pos += 1
        out = []
        while self._peek() and self._peek() != quote:
            out.append(self.text[self.pos])
            self.pos += 1
        self._expect(quote)
        return "".join(out)

    def parse_single_value(self) -> AstValue:
        self._skip_ws()
        ch = self._peek()
        if ch in "\"'":
            return AstValue(self._string())
        name = self._ident()
        self._skip_ws()
        if self._peek() == "(":
            self.pos += 1
            args: list[AstArg] = []
            self._skip_ws()
            if self._peek() != ")":
                while True:
                    args.append(self.parse_arg())
                    self._skip_ws()
                    if self._peek() == ",":
                        self.pos += 1
                        continue
                    break
            self._expect(")")
            return AstValue(name, True, args)
        return AstValue(name, False, [])

    def parse_arg(self) -> AstArg:
        self._skip_ws()
        save = self.pos
        try:
            kw = self._ident()
            self._skip_ws()
            if self._peek() == "=":
                self.pos += 1
                return AstArg(self.parse_value(), kw)
        except ParseError:
            pass
        self.pos = save
        return AstArg(self.parse_value())

    def parse_value(self) -> AstValue:
        """Parse a value including chain sugar a:b:c -> chain(a, chain(b, c))."""
        v = self.parse_single_value()
        self._skip_ws()
        if self._peek() == ":":
            self.pos += 1
            rest = self.parse_value()
            return AstValue(
                "chain", True, [AstArg(v), AstArg(rest)]
            )
        return v

    def parse_full(self) -> AstValue:
        v = self.parse_value()
        self._skip_ws()
        if self.pos != len(self.text):
            raise ParseError(f"trailing input at {self.pos} in {self.text!r}")
        return v


def parse(text: str) -> AstValue:
    return Parser(text).parse_full()


def evaluate(ast: Union[AstValue, str], algo_type: str, registry) -> AlgorithmValue:
    """Evaluate an AST against the declared signatures in `registry`.

    Mirror of eval::cl_eval (AlgorithmStringParser.hpp:279, eval :94-277):
    looks up the algorithm's Meta, binds positional args to declared options
    in order, keyword args by name, fills defaults, and recurses into
    templated sub-algorithm options.
    """
    if isinstance(ast, str):
        ast = parse(ast)

    cls = registry.get_class(algo_type, ast.name)
    meta: Meta = cls.meta()

    decls = list(meta.options.values())
    bound: dict[str, AstValue] = {}

    pos_idx = 0
    seen_keyword = False
    for arg in ast.args:
        if arg.keyword is not None:
            seen_keyword = True
            if arg.keyword not in meta.options:
                raise ParseError(
                    f"unknown option {arg.keyword!r} for algorithm {ast.name!r}"
                )
            if arg.keyword in bound:
                raise ParseError(f"duplicate option {arg.keyword!r} for {ast.name!r}")
            bound[arg.keyword] = arg.value
        else:
            if seen_keyword:
                raise ParseError(
                    f"positional arg after keyword arg in {ast.name!r}"
                )
            # find next unbound declared option
            while pos_idx < len(decls) and decls[pos_idx].name in bound:
                pos_idx += 1
            if pos_idx >= len(decls):
                raise ParseError(f"too many positional args for {ast.name!r}")
            bound[decls[pos_idx].name] = arg.value
            pos_idx += 1

    options: dict[str, Any] = {}
    for decl in decls:
        if decl.name in bound:
            v = bound[decl.name]
            if decl.kind in ("templated", "dynamic_compressor"):
                options[decl.name] = evaluate(v, decl.algo_type, registry)
            else:
                # dynamic: value is the raw string form
                options[decl.name] = str(v)
        else:
            if decl.kind == "templated":
                if decl.default is None:
                    raise ParseError(
                        f"missing required option {decl.name!r} for {ast.name!r}"
                    )
                options[decl.name] = evaluate(
                    parse(decl.default), decl.algo_type, registry
                )
            elif decl.kind == "dynamic_compressor":
                raise ParseError(
                    f"missing required option {decl.name!r} for {ast.name!r}"
                )
            else:
                if decl.default is None:
                    raise ParseError(
                        f"missing required option {decl.name!r} for {ast.name!r}"
                    )
                options[decl.name] = decl.default

    return AlgorithmValue(meta.name, options, type=meta.type)
